"""The port's ``cephfs/`` against the JAX package's, on the CPU.

Every case of ``tests/test_cephfs.py`` (the tree, striped sparse file
I/O, truncate, rename and rmdir guards, symlinks, checkpoint and restore,
the EC data pool, setattr), ``test_cephfs_hardlinks.py``,
``test_cephfs_quota.py`` (quotas and layouts through the MDS),
``test_cephfs_snapshots.py`` and the filesystem cases of
``test_fsck_gc.py`` runs on both packages with the same inputs,
``uuid.uuid4`` drawn from one seeded sequence and the filesystem's
``time.time`` from one fake clock: each package's run passes the case's
own assertions, prints the same output, and every cluster the case
builds stores the same objects (directory omaps with their embedded
inodes, the InoTable, the snapshot table, file data, the MDS journal)
on every OSD.  The port's EC data pool runs ``backend=host``.

The cases of ``test_fsck_gc.py`` that drive ``rgw/`` (``RGWLite`` and
``rgw_admin``) run on the port's ``rgw/``, its keys and ids seeded and
its clock faked as in ``test_torch_rgw.py``.  Beside the twins: each
method of the ``fs`` object class fed the same seeded requests on both
packages' OSDs, and each ``cephfs_cli`` verb's output.
"""
import inspect
import json
import random

import pytest

import test_cephfs
import test_cephfs_hardlinks
import test_cephfs_quota
import test_cephfs_snapshots
import test_fsck_gc
from torch_daemon_twin import clean  # noqa: F401 (a fixture)
from torch_daemon_twin import JAX, PORT, assert_same_state, store_state
from torch_rbd_twin import (assert_same_runs, case_names, port_module,
                            run_both)

MODULES = {m.__name__: m for m in (test_cephfs, test_cephfs_hardlinks,
                                   test_cephfs_quota,
                                   test_cephfs_snapshots, test_fsck_gc)}
PORTS = {name: port_module(m) for name, m in MODULES.items()}


def _uses_rgw(fn):
    return "RGWLite" in inspect.getsource(fn) or \
        "rgw_admin" in inspect.getsource(fn)


RGW_CASES = [c for c in case_names(test_fsck_gc)
             if _uses_rgw(getattr(test_fsck_gc, c))]
CASES = [(mod, case) for mod, m in MODULES.items()
         for case in case_names(m)]


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}::{c}" for m, c in CASES])
def test_cephfs_case_equal(mod, name, tmp_path, capsys):
    j, p = run_both(MODULES[mod], name, tmp_path, capsys,
                    port=PORTS[mod])
    assert j.clusters and all(j.states())
    assert_same_runs(j, p)


def test_twins_run_the_ports_filesystem():
    """The twin modules hold the port's classes, and the cases that need
    ``rgw/`` run on the port's gateway among the twins."""
    import ceph_tpu_torch.cephfs as pfs
    assert PORTS["test_cephfs"].CephFS is pfs.CephFS
    assert PORTS["test_cephfs_quota"].MDSDaemon.__module__ == \
        "ceph_tpu_torch.mds.server"
    import ceph_tpu_torch.rgw as prgw
    assert PORTS["test_fsck_gc"].RGWLite is prgw.RGWLite
    assert RGW_CASES == ["test_rgw_gc",
                         "test_gc_collects_deleted_bucket_debris",
                         "test_cli_verbs"]
    assert {("test_fsck_gc", c) for c in RGW_CASES} <= set(CASES)


# ---- the fs object class -----------------------------------------------

def _requests(seed):
    """A seeded run of requests over every ``fs`` method, on two
    directory objects, the InoTable and the snapshot table."""
    rng = random.Random(seed)
    names = [f"n{i}" for i in range(5)]

    def inode():
        return {"ino": rng.randrange(2, 1 << 20),
                "type": rng.choice(["file", "dir", "remote", "symlink"]),
                "size": rng.randrange(0, 1 << 22),
                "mtime": rng.randrange(0, 1 << 30) / 8.0}

    out = [("mds_inotable", "mkfs", {}), ("mds_inotable", "mkfs", {})]
    for _ in range(48):
        d = rng.choice(["1.00000000", "2.00000000"])
        n = rng.choice(names)
        m = rng.choice(["alloc_ino", "link", "unlink", "lookup",
                        "readdir", "dir_empty", "dir_mark_dead",
                        "update_inode", "snap_add", "snap_rm", "snap_ls",
                        "set_dentry", "rename_local"])
        if m == "alloc_ino":
            out.append(("mds_inotable", m, {}))
        elif m == "link":
            out.append((d, m, {"name": n, "inode": inode()}))
        elif m == "unlink":
            out.append((d, m, {"name": n,
                               "deny_dir": rng.random() < 0.5}))
        elif m == "lookup":
            out.append((d, m, {"name": n}))
        elif m in ("readdir", "dir_empty", "dir_mark_dead"):
            out.append((d, m, {}))
        elif m == "update_inode":
            out.append((d, m, {
                "name": n, "attrs": {"mode": rng.randrange(0, 0o777)},
                "max_attrs": {"size": rng.randrange(0, 1 << 22)},
                "add_links": [[rng.randrange(2, 9), rng.choice(names)]],
                "remove_links": [[3, rng.choice(names)]]}))
        elif m in ("snap_add", "snap_rm"):
            out.append(("fs_snaps", m, {
                "name": f"s{rng.randrange(3)}",
                "md_sid": rng.randrange(1, 99),
                "data_sid": rng.randrange(1, 99),
                "stamp": rng.randrange(0, 1 << 30) / 4.0}))
        elif m == "snap_ls":
            out.append(("fs_snaps", m, {}))
        elif m == "set_dentry":
            req = {"name": n, "inode": inode()}
            if rng.random() < 0.5:
                req["expect_remote_ino"] = rng.randrange(2, 1 << 20)
            out.append((d, m, req))
        else:
            out.append((d, m, {"src": n, "dst": rng.choice(names),
                               "replace": rng.random() < 0.5}))
    return out


def _boot(pkg):
    import chip_smoke
    d = chip_smoke.Daemons(pkg, 4)
    d.create_replicated_pool("meta", 3, 8)
    return d, d.client()


@pytest.mark.parametrize("seed", [1, 22, 333, 4444])
def test_fs_class_answers_as_jax(seed, clean):
    """Each ``fs`` method, fed the same seeded requests (the directory
    objects created first, one sealed by ``dir_mark_dead`` when the draw
    says so) on both packages' OSDs: equal ``(rc, out)`` per call and
    equal objects, omaps included."""
    res = {}
    for pkg in (JAX, PORT):
        d, cl = _boot(pkg)
        for oid in ("1.00000000", "2.00000000", "fs_snaps"):
            assert cl.write_full("meta", oid, b"") == 0
        res[pkg] = ([cl.exec("meta", oid, "fs", method,
                             json.dumps(req).encode())
                     for oid, method, req in _requests(seed)],
                    store_state(d))
        d.shutdown()
    assert res[PORT][0] == res[JAX][0]
    assert {rc for rc, _out in res[PORT][0]} & {0}
    assert_same_state(res[JAX][1], res[PORT][1])


# ---- cephfs_cli ---------------------------------------------------------

CLI_BODY = b"".join(b"line %d of the file\n" % i for i in range(400))
CLI_SCRIPT = [
    ["mkfs"], ["mkdir", "/d"], ["put", "{local}", "/d/f"], ["ls", "/d"],
    ["cat", "/d/f"], ["ln", "/d/f", "/lnk"], ["ls"], ["stat", "/d/f"],
    ["chmod", "640", "/d/f"], ["chown", "7:9", "/d/f"], ["stat", "/d/f"],
    ["mv", "/d/f", "/d/g"], ["get", "/d/g", "{out}"], ["tree"],
    ["fsck"], ["rm", "/d/g"], ["rmdir", "/d"], ["tree", "/"],
]


def _cli_run(pkg, tmp_path, capsys):
    from importlib import import_module
    cluster = import_module(pkg + ".cluster")
    cli = import_module(pkg + ".tools.cephfs_cli")
    c = cluster.MiniCluster(n_osds=3)
    c.create_replicated_pool("fsmeta", size=2, pg_num=8)
    c.create_replicated_pool("fsdata", size=2, pg_num=8)
    cl = c.client("client.cli")
    local = tmp_path / f"{pkg}.in"
    local.write_bytes(CLI_BODY)
    out = tmp_path / f"{pkg}.out"
    outs = []
    capsys.readouterr()
    for argv in CLI_SCRIPT:
        argv = [a.format(local=local, out=out) for a in argv]
        outs.append((cli.run(c, cl, argv), capsys.readouterr().out))
    return outs, out.read_bytes(), store_state(c)


def test_cephfs_cli_verbs_equal(tmp_path, capsys, monkeypatch):
    """Every verb of ``cephfs_cli.run`` but ``fsck --repair`` (in
    ``test_fsck_gc.py``'s twins) in one script: equal exit codes, equal
    output (the filesystem's clock faked as in the twins) and equal
    stores."""
    import time
    import uuid
    from torch_rbd_twin import fs_clock, seeded_uuid4
    res = {}
    for pkg in (JAX, PORT):
        monkeypatch.setattr(uuid, "uuid4", seeded_uuid4())
        monkeypatch.setattr(time, "time", fs_clock())
        res[pkg] = _cli_run(pkg, tmp_path, capsys)
    assert res[PORT][0] == res[JAX][0]
    assert all(rc == 0 for rc, _out in res[PORT][0])
    assert res[PORT][1] == CLI_BODY
    assert_same_state(res[JAX][2], res[PORT][2])
