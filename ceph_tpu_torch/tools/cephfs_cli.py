"""cephfs CLI — a cephfs-shell-style tool (src/tools/cephfs-shell in
later reference versions; the mount-and-poke role of qa workunits).

Verbs: mkfs, ls, mkdir, put/get (local file <-> fs file), cat, rm,
rmdir, mv, ln, stat, tree.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..cephfs import CephFS


def run(cluster, client, argv, meta_pool: str = "fsmeta",
        data_pool: str = "fsdata") -> int:
    ap = argparse.ArgumentParser(prog="cephfs")
    ap.add_argument("--meta-pool", default=meta_pool)
    ap.add_argument("--data-pool", default=data_pool)
    ap.add_argument("verb", choices=[
        "mkfs", "ls", "mkdir", "put", "get", "cat", "rm", "rmdir",
        "mv", "ln", "stat", "tree", "fsck", "chmod", "chown"])
    ap.add_argument("--repair", action="store_true")
    ap.add_argument("args", nargs="*")
    a = ap.parse_args(argv)
    fs = CephFS(client, a.meta_pool, a.data_pool)
    v, rest = a.verb, a.args
    if v == "mkfs":
        fs.mkfs()
    elif v == "ls":
        (path,) = rest or ["/"]
        for name, ino in sorted(fs.listdir(path).items()):
            kind = {"dir": "d", "symlink": "l",
                    "remote": "h"}.get(ino.get("type"), "-")
            print(f"{kind} {ino.get('size', 0):>10} {name}")
    elif v == "mkdir":
        (path,) = rest
        fs.mkdir(path)
    elif v == "put":
        local, remote = rest
        with open(local, "rb") as f:
            data = f.read()
        if not fs.exists(remote):
            fs.create(remote)
        fs.truncate(remote, 0)
        fs.write(remote, data)
    elif v == "get":
        remote, local = rest
        with open(local, "wb") as f:
            f.write(fs.read(remote))
    elif v == "cat":
        (path,) = rest
        sys.stdout.buffer.write(fs.read(path))
    elif v == "rm":
        (path,) = rest
        fs.unlink(path)
    elif v == "rmdir":
        (path,) = rest
        fs.rmdir(path)
    elif v == "mv":
        src, dst = rest
        fs.rename(src, dst)
    elif v == "ln":
        target, link = rest
        fs.symlink(link, target)
    elif v == "stat":
        (path,) = rest
        json.dump(fs.stat(path), sys.stdout, indent=2, sort_keys=True)
        print()
    elif v == "chmod":
        mode, path = rest
        fs.chmod(path, int(mode, 8))
    elif v == "chown":
        owner, path = rest
        uid, gid = owner.split(":")
        fs.chown(path, int(uid), int(gid))
    elif v == "fsck":
        json.dump(fs.fsck(repair=a.repair), sys.stdout, indent=2,
                  sort_keys=True)
        print()
    elif v == "tree":
        (path,) = rest or ["/"]
        for dirpath, dirs, files in fs.walk(path):
            print(dirpath)
            for f in files:
                print(f"  {f}")
    return 0


def main(argv=None) -> int:  # pragma: no cover - thin shell wrapper
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="cephfs", add_help=False)
    ap.add_argument("--checkpoint", required=True)
    ns, rest = ap.parse_known_args(argv)
    from ..cluster import MiniCluster
    c = MiniCluster.restore(ns.checkpoint)
    return run(c, c.client("client.fs-cli"), rest)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
