"""radosgw-admin CLI (src/rgw/rgw_admin.cc in the reference): user and
bucket administration against a MiniCluster checkpoint.

Verbs mirror the reference's common surface: user create/info/rm/list,
bucket list/stats/rm, and object listing within a bucket.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..rgw import RGWError, RGWLite


def run(cluster, client, argv, meta_pool: str = "rgwmeta",
        data_pool: str = "rgwdata") -> int:
    ap = argparse.ArgumentParser(prog="radosgw-admin")
    ap.add_argument("--meta-pool", default=meta_pool)
    ap.add_argument("--data-pool", default=data_pool)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("user")
    s.add_argument("verb", choices=["create", "info", "rm", "list",
                                    "modify", "suspend", "enable",
                                    "stats", "check"])
    s.add_argument("--uid", default=None)
    s.add_argument("--display-name", default="")
    s.add_argument("--max-buckets", type=int, default=None)
    s = sub.add_parser("key")
    s.add_argument("verb", choices=["create", "rm"])
    s.add_argument("--uid", default=None)
    s.add_argument("--access-key", default=None)
    s = sub.add_parser("caps")
    s.add_argument("verb", choices=["add", "rm"])
    s.add_argument("--uid", default=None)
    s.add_argument("--caps", default="")
    s = sub.add_parser("quota")
    s.add_argument("verb", choices=["set", "enable", "disable",
                                    "get"])
    s.add_argument("--uid", default=None)
    s.add_argument("--max-size", type=int, default=None)
    s.add_argument("--max-objects", type=int, default=None)
    s.add_argument("--quota-scope", default="user")
    s = sub.add_parser("bucket")
    s.add_argument("verb", choices=["list", "stats", "rm", "link",
                                    "unlink"])
    s.add_argument("--bucket", default=None)
    s.add_argument("--uid", default=None)
    s = sub.add_parser("gc")
    s.add_argument("verb", choices=["list", "process"])
    s = sub.add_parser("lc")
    s.add_argument("verb", choices=["list", "process"])
    s.add_argument("--bucket", default=None)
    args = ap.parse_args(argv)

    g = RGWLite(client, args.meta_pool, args.data_pool)
    out = sys.stdout
    try:
        return _dispatch(g, client, args, out)
    except RGWError as e:
        print(f"{args.cmd} {args.verb} failed: {e}", file=sys.stderr)
        return 1


def _dispatch(g, client, args, out) -> int:
    if args.cmd == "user":
        if args.verb == "create":
            u = g.create_user(args.uid, args.display_name)
            json.dump(u, out, indent=2, sort_keys=True)
            print(file=out)
        elif args.verb == "info":
            json.dump(g.get_user(args.uid), out, indent=2,
                      sort_keys=True)
            print(file=out)
        elif args.verb == "rm":
            g.delete_user(args.uid)
        elif args.verb == "list":
            for uid in g.list_users():
                print(uid, file=out)
        elif args.verb == "modify":
            u = g.modify_user(args.uid,
                              display_name=args.display_name or None,
                              max_buckets=args.max_buckets)
            json.dump(u, out, indent=2, sort_keys=True)
            print(file=out)
        elif args.verb in ("suspend", "enable"):
            u = g.modify_user(args.uid,
                              suspended=(args.verb == "suspend"))
            json.dump({"uid": u["uid"],
                       "suspended": u.get("suspended", False)},
                      out, indent=2, sort_keys=True)
            print(file=out)
        elif args.verb in ("stats", "check"):
            json.dump(g.user_stats(args.uid), out, indent=2,
                      sort_keys=True)
            print(file=out)
    elif args.cmd == "key":
        if args.verb == "create":
            json.dump(g.user_add_key(args.uid), out, indent=2,
                      sort_keys=True)
            print(file=out)
        else:
            g.user_rm_key(args.uid, args.access_key or "")
    elif args.cmd == "caps":
        caps = g.user_caps(args.uid,
                           add=args.caps if args.verb == "add"
                           else None,
                           rm=args.caps if args.verb == "rm"
                           else None)
        json.dump(caps, out, indent=2, sort_keys=True)
        print(file=out)
    elif args.cmd == "quota":
        if args.quota_scope != "user":
            print("quota: only --quota-scope=user is implemented",
                  file=sys.stderr)
            return 1
        if args.verb == "set":
            q = g.set_user_quota(args.uid, max_size=args.max_size,
                                 max_objects=args.max_objects)
        elif args.verb in ("enable", "disable"):
            q = g.set_user_quota(args.uid,
                                 enabled=(args.verb == "enable"))
        else:
            q = g.get_user(args.uid).get("quota", {})
        json.dump(q, out, indent=2, sort_keys=True)
        print(file=out)
    elif args.cmd == "gc":
        report = g.gc(repair=(args.verb == "process"))
        json.dump(report, out, indent=2, sort_keys=True)
        print(file=out)
    elif args.cmd == "lc":
        if args.verb == "list":
            json.dump(g.get_bucket_lifecycle(args.bucket), out,
                      indent=2, sort_keys=True)
        else:
            json.dump(g.lc_process(), out, indent=2, sort_keys=True)
        print(file=out)
    elif args.cmd == "bucket":
        if args.verb == "list":
            if args.uid:
                for b in g.list_buckets(args.uid):
                    print(b, file=out)
            elif args.bucket:
                for e in g.list_objects(args.bucket)["contents"]:
                    print(e["name"], file=out)
        elif args.verb == "stats":
            json.dump(g.bucket_stats(args.bucket), out, indent=2,
                      sort_keys=True)
            print(file=out)
        elif args.verb == "rm":
            g.delete_bucket(args.bucket)
        elif args.verb == "link":
            g.link_bucket(args.bucket, args.uid)
        elif args.verb == "unlink":
            g.unlink_bucket(args.bucket, args.uid)
    return 0


def main(argv=None) -> int:  # pragma: no cover - thin shell wrapper
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "--help" in argv or "-h" in argv:
        # the reference prints its full usage and exits 1
        # (src/rgw/rgw_admin.cc usage(); src/test/cli/radosgw-admin/
        # help.t pins the bytes)
        from .rgw_admin_usage import USAGE
        sys.stdout.write(USAGE)
        return 1
    ap = argparse.ArgumentParser(prog="radosgw-admin", add_help=False)
    ap.add_argument("--checkpoint", required=True)
    ns, rest = ap.parse_known_args(argv)
    from ..cluster import MiniCluster
    c = MiniCluster.restore(ns.checkpoint)
    rc = run(c, c.client("client.rgw-admin"), rest)
    # rados.py's CLI contract: persist mutations back; reads don't
    # rewrite the checkpoint
    toks = [t for t in rest if not t.startswith("-")]
    mutating = (len(toks) >= 2 and
                (toks[0], toks[1]) in {
                    ("user", "create"), ("user", "rm"),
                    ("user", "modify"), ("user", "suspend"),
                    ("user", "enable"), ("key", "create"),
                    ("key", "rm"), ("caps", "add"), ("caps", "rm"),
                    ("quota", "set"), ("quota", "enable"),
                    ("quota", "disable"), ("bucket", "rm"),
                    ("bucket", "link"), ("bucket", "unlink"),
                    ("gc", "process"), ("lc", "process")})
    if rc == 0 and mutating:
        c.checkpoint(ns.checkpoint)
    return rc


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
