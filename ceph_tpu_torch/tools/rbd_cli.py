"""rbd CLI (src/tools/rbd in the reference): image admin over a
MiniCluster checkpoint or live in-process cluster.

Subcommands mirror the reference verbs used in its qa suites
(qa/workunits/rbd/): create/ls/info/resize/rm/snap/clone/flatten plus
import/export for moving data in and out of images.

Port of ``ceph_tpu/tools/rbd_cli.py``, a copy.  A restored EC pool's
codec follows the pool's profile (``backend=host`` pools run on the
CPU, the default ``cuda`` backend on the card).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..rbd import RBD, Image


def run(cluster, client, argv) -> int:
    """Drive rbd verbs against an existing cluster+client (the testable
    entry; ``main`` wraps it with checkpoint loading)."""
    ap = argparse.ArgumentParser(prog="rbd")
    ap.add_argument("-p", "--pool", default="rbd")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("create")
    s.add_argument("image")
    s.add_argument("--size", type=int, required=True)
    s.add_argument("--order", type=int, default=22)
    s.add_argument("--data-pool", default=None)
    s.add_argument("--journaling", action="store_true")
    sub.add_parser("ls")
    s = sub.add_parser("info")
    s.add_argument("image")
    s = sub.add_parser("du")
    s.add_argument("spec", help="image[@snap]")
    s = sub.add_parser("resize")
    s.add_argument("image")
    s.add_argument("--size", type=int, required=True)
    s = sub.add_parser("rm")
    s.add_argument("image")
    s = sub.add_parser("snap")
    s.add_argument("verb", choices=["create", "rm", "ls", "protect",
                                    "unprotect", "rollback"])
    s.add_argument("spec", help="image[@snap]")
    s = sub.add_parser("clone")
    s.add_argument("parent_spec", help="image@snap")
    s.add_argument("child")
    s = sub.add_parser("flatten")
    s.add_argument("image")
    s = sub.add_parser("lock")
    s.add_argument("verb", choices=["add", "ls", "rm"])
    s.add_argument("image")
    s.add_argument("--cookie", default="")
    s.add_argument("--locker", default="")
    s = sub.add_parser("export")
    s.add_argument("image")
    s.add_argument("path")
    s = sub.add_parser("import")
    s.add_argument("path")
    s.add_argument("image")
    s.add_argument("--order", type=int, default=22)
    s = sub.add_parser("export-diff")
    s.add_argument("image")
    s.add_argument("path")
    s.add_argument("--from-snap", default=None)
    s.add_argument("--snap", default=None)
    s = sub.add_parser("import-diff")
    s.add_argument("path")
    s.add_argument("image")
    s = sub.add_parser("cp")
    s.add_argument("src")
    s.add_argument("dst")
    s.add_argument("--snap", default=None)
    args = ap.parse_args(argv)

    rbd = RBD(client)
    pool = args.pool
    if args.cmd == "create":
        rbd.create(pool, args.image, args.size, args.order,
                   data_pool=args.data_pool,
                   journaling=args.journaling)
    elif args.cmd == "ls":
        print("\n".join(rbd.list(pool)))
    elif args.cmd == "du":
        name, _, snap = args.spec.partition("@")
        img = Image(client, pool, name, snapshot=snap or None)
        print(json.dumps(img.du(), sort_keys=True))
    elif args.cmd == "info":
        print(json.dumps(Image(client, pool, args.image).stat(),
                         indent=2, sort_keys=True))
    elif args.cmd == "resize":
        Image(client, pool, args.image).resize(args.size)
    elif args.cmd == "rm":
        rbd.remove(pool, args.image)
    elif args.cmd == "snap":
        if args.verb == "ls":
            img = Image(client, pool, args.spec)
            print(json.dumps(img.snap_list(), indent=2, sort_keys=True))
        else:
            name, snap = args.spec.split("@", 1)
            img = Image(client, pool, name)
            getattr(img, {"create": "snap_create", "rm": "snap_remove",
                          "protect": "snap_protect",
                          "unprotect": "snap_unprotect",
                          "rollback": "snap_rollback"}[args.verb])(snap)
    elif args.cmd == "clone":
        pname, snap = args.parent_spec.split("@", 1)
        rbd.clone(pool, pname, snap, pool, args.child)
    elif args.cmd == "flatten":
        Image(client, pool, args.image).flatten()
    elif args.cmd == "lock":
        img = Image(client, pool, args.image)
        if args.verb == "add":
            r = img.lock_exclusive(args.cookie)
            if r < 0:
                print(f"lock failed: {r}", file=sys.stderr)
                return 1
        elif args.verb == "ls":
            print(json.dumps(img.list_lockers(), indent=2,
                             sort_keys=True))
        elif args.verb == "rm":
            r = (img.break_lock(args.locker, args.cookie)
                 if args.locker else img.unlock(args.cookie))
            if r < 0:
                print(f"unlock failed: {r}", file=sys.stderr)
                return 1
    elif args.cmd == "export":
        img = Image(client, pool, args.image)
        with open(args.path, "wb") as f:
            f.write(img.read(0, img.size()))
    elif args.cmd == "export-diff":
        img = Image(client, pool, args.image)
        with open(args.path, "wb") as fh:
            fh.write(img.export_diff(from_snap=args.from_snap,
                                     to_snap=args.snap))
    elif args.cmd == "import-diff":
        with open(args.path, "rb") as fh:
            Image(client, pool, args.image).import_diff(fh.read())
    elif args.cmd == "cp":
        rbd.copy(pool, args.src, pool, args.dst, src_snap=args.snap)
    elif args.cmd == "import":
        with open(args.path, "rb") as f:
            data = f.read()
        rbd.create(pool, args.image, len(data), args.order)
        Image(client, pool, args.image).write(0, data)
    return 0


def main(argv=None) -> int:  # pragma: no cover - thin shell wrapper
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="rbd", add_help=False)
    ap.add_argument("--checkpoint", required=True)
    ns, rest = ap.parse_known_args(argv)
    from ..cluster import MiniCluster
    c = MiniCluster.restore(ns.checkpoint)
    rc = run(c, c.client("client.rbd-cli"), rest)
    # match rados.py: persist mutations back into the checkpoint,
    # but don't rewrite it for read-only verbs
    toks: list[str] = []
    skip = False
    for t in rest:
        if skip:
            skip = False
        elif t in ("-p", "--pool"):
            skip = True                # option value, not a verb
        elif not t.startswith("-"):
            toks.append(t)
    readonly = (not toks or toks[0] in ("ls", "info", "du", "export",
                                        "export-diff")
                or (toks[0] in ("snap", "lock") and len(toks) > 1
                    and toks[1] == "ls"))
    if rc == 0 and not readonly:
        c.checkpoint(ns.checkpoint)
    return rc


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
