"""The port's ``rgw/`` and ``radosgw-admin`` against the JAX package's, on
the CPU.

Every case of ``tests/test_rgw.py`` (buckets, chunked objects on an EC
data pool, listing, the two-phase index, multipart, the S3 and Swift
frontends over sockets), ``test_rgw_admin_users.py``, ``test_rgw_rest.py``,
``test_rgw_sigv4.py`` and ``test_rgw_versioning.py`` runs on both packages
with the same inputs: ``secrets.token_hex`` (keys, bucket ids, index
tags, version and upload ids) drawn from one seeded sequence, and the
gateway's and the case's ``time.time`` from one fake clock that starts
at the real time, both restarted for each package.  Each package's run
passes the case's own assertions, prints the same output, and every
cluster the case builds stores the same objects (user and bucket
records, bucket index omaps, chunk and part objects) on every OSD.  The
port's EC data pool runs ``backend=host``.

Beside the twins: each method of the ``rgw`` object class fed the same
seeded requests on both packages' OSDs, and ``radosgw-admin``'s usage
text and every verb's output.
"""
import json
import random

import pytest

import test_rgw
import test_rgw_admin_users
import test_rgw_rest
import test_rgw_sigv4
import test_rgw_versioning
from torch_daemon_twin import clean  # noqa: F401 (a fixture)
from torch_daemon_twin import JAX, PORT, assert_same_state, store_state
from torch_rbd_twin import (assert_same_runs, case_names, port_module,
                            run_both)

MODULES = {m.__name__: m for m in (test_rgw, test_rgw_admin_users,
                                   test_rgw_rest, test_rgw_sigv4,
                                   test_rgw_versioning)}
PORTS = {name: port_module(m) for name, m in MODULES.items()}
CASES = [(mod, case) for mod, m in MODULES.items()
         for case in case_names(m)]


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}::{c}" for m, c in CASES])
def test_rgw_case_equal(mod, name, tmp_path, capsys):
    j, p = run_both(MODULES[mod], name, tmp_path, capsys,
                    port=PORTS[mod])
    assert j.clusters and all(j.states())
    assert_same_runs(j, p)


def test_twins_run_the_ports_gateway():
    """The twin modules hold the port's gateway, frontends and admin
    tool, and every case of the five JAX files is twinned."""
    import ceph_tpu_torch.rgw as prgw
    from ceph_tpu_torch.tools import rgw_admin
    assert PORTS["test_rgw"].RGWLite is prgw.RGWLite
    assert PORTS["test_rgw"].S3Frontend is prgw.S3Frontend
    assert PORTS["test_rgw_admin_users"].run is rgw_admin.run
    assert PORTS["test_rgw_sigv4"].sign_v4.__module__ == \
        "ceph_tpu_torch.rgw.http"
    assert len(CASES) == 46


# ---- the rgw object class ----------------------------------------------

def _requests(seed):
    """A seeded run of requests over every ``rgw`` method on two bucket
    index objects: prepares, completes (some of unknown tags), cancels,
    listings with prefix/marker/max_keys, entry lookups and stats."""
    rng = random.Random(seed)
    names = [f"{p}{i}" for p in ("a/", "b/", "") for i in range(4)]
    tags = [f"t{i}" for i in range(6)]
    out = []
    for _ in range(64):
        idx = rng.choice([".dir.b1", ".dir.b2"])
        m = rng.choice(["bucket_prepare_op", "bucket_complete_op",
                        "bucket_cancel_op", "bucket_list",
                        "bucket_get_entry", "bucket_stats"])
        if m == "bucket_prepare_op":
            out.append((idx, m, {"tag": rng.choice(tags),
                                 "name": rng.choice(names),
                                 "op": rng.choice(["put", "del"])}))
        elif m == "bucket_complete_op":
            meta = {"size": rng.randrange(0, 1 << 24),
                    "etag": "%032x" % rng.getrandbits(128),
                    "mtime": rng.randrange(0, 1 << 30) / 8.0}
            out.append((idx, m, {"tag": rng.choice(tags),
                                 "name": rng.choice(names),
                                 "op": rng.choice(["put", "del"]),
                                 "meta": meta}))
        elif m == "bucket_cancel_op":
            out.append((idx, m, {"tag": rng.choice(tags)}))
        elif m == "bucket_list":
            out.append((idx, m, {"prefix": rng.choice(["", "a/", "b/"]),
                                 "marker": rng.choice(["", "a/1", "b/2"]),
                                 "max_keys": rng.randrange(1, 6)}))
        elif m == "bucket_get_entry":
            out.append((idx, m, {"name": rng.choice(names)}))
        else:
            out.append((idx, m, {}))
    return out


def _boot(pkg):
    import chip_smoke
    d = chip_smoke.Daemons(pkg, 4)
    d.create_replicated_pool("meta", 3, 8)
    return d, d.client()


@pytest.mark.parametrize("seed", [1, 22, 333, 4444])
def test_rgw_class_answers_as_jax(seed, clean):
    """Each ``rgw`` method, fed the same seeded requests (one index
    object created first, the other left absent so that a listing or
    stats of it answers ESTALE until a write creates it) on both
    packages' OSDs: equal ``(rc, out)`` per call and equal objects,
    omaps included."""
    res = {}
    for pkg in (JAX, PORT):
        d, cl = _boot(pkg)
        assert cl.write_full("meta", ".dir.b1", b"") == 0
        res[pkg] = ([cl.exec("meta", oid, "rgw", method,
                             json.dumps(req).encode())
                     for oid, method, req in _requests(seed)],
                    store_state(d))
        d.shutdown()
    assert res[PORT][0] == res[JAX][0]
    assert {rc for rc, _out in res[PORT][0]} >= {0}
    assert_same_state(res[JAX][1], res[PORT][1])


# ---- radosgw-admin ------------------------------------------------------

ADMIN_SCRIPT = [
    ["user", "create", "--uid", "alice", "--display-name", "Alice"],
    ["user", "create", "--uid", "bob", "--display-name", "Bob"],
    ["user", "info", "--uid", "alice"], ["user", "list"],
    ["user", "modify", "--uid", "alice", "--display-name", "Al",
     "--max-buckets", "4"],
    ["user", "suspend", "--uid", "bob"], ["user", "enable", "--uid", "bob"],
    ["user", "stats", "--uid", "alice"], ["user", "check", "--uid", "alice"],
    ["key", "create", "--uid", "alice"],
    ["caps", "add", "--uid", "alice", "--caps", "users=read, write"],
    ["caps", "rm", "--uid", "alice", "--caps", "users=write"],
    ["quota", "set", "--uid", "alice", "--max-size", "1048576",
     "--max-objects", "9"],
    ["quota", "enable", "--uid", "alice"], ["quota", "get", "--uid", "alice"],
    ["quota", "disable", "--uid", "alice"],
    ["quota", "get", "--uid", "alice", "--quota-scope", "bucket"],
    ["bucket", "list", "--uid", "alice"],
    ["bucket", "list", "--bucket", "photos"],
    ["bucket", "stats", "--bucket", "photos"],
    ["bucket", "unlink", "--bucket", "photos", "--uid", "alice"],
    ["bucket", "link", "--bucket", "photos", "--uid", "bob"],
    ["bucket", "list", "--uid", "bob"],
    ["lc", "list", "--bucket", "photos"], ["lc", "process"],
    ["gc", "list"], ["gc", "process"],
    ["bucket", "rm", "--bucket", "empty"],
    ["key", "rm", "--uid", "bob", "--access-key", "nope"],
    ["user", "info", "--uid", "carol"],
    ["bucket", "unlink", "--bucket", "photos", "--uid", "bob"],
    ["user", "rm", "--uid", "bob"], ["user", "list"],
]
# the verbs that must fail (exit 1, a message on stderr)
ADMIN_FAILS = [16, 28, 29]


def _admin_run(pkg, capsys):
    from importlib import import_module
    cluster = import_module(pkg + ".cluster")
    admin = import_module(pkg + ".tools.rgw_admin")
    rgw = import_module(pkg + ".rgw")
    c = cluster.MiniCluster(n_osds=3)
    c.create_replicated_pool("rgwmeta", size=2, pg_num=8)
    c.create_ec_pool("rgwdata", k=2, m=1, plugin="isa", pg_num=8,
                     extra_profile={"backend": "host"} if pkg == PORT
                     else None)
    cl = c.client("client.rgw-admin")
    outs = []
    capsys.readouterr()
    for argv in ADMIN_SCRIPT:
        if argv[:2] == ["bucket", "list"] and argv[2:3] == ["--uid"] and \
                argv[3] == "alice":
            # a bucket with objects (and one left empty) for the bucket
            # and lifecycle verbs
            g = rgw.RGWLite(cl, "rgwmeta", "rgwdata")
            g.create_bucket("alice", "photos")
            g.create_bucket("alice", "empty")
            g.put_object("photos", "a.jpg", b"x" * 5000)
            g.put_object("photos", "b.jpg", b"y" * 700)
            g.put_bucket_lifecycle("photos", [{
                "id": "r", "prefix": "a", "status": "Enabled",
                "expiration_days": 1}])
        rc = admin.run(c, cl, argv)
        cap = capsys.readouterr()
        outs.append((rc, cap.out, cap.err))
    return outs, store_state(c)


def test_rgw_admin_verbs_equal(capsys, monkeypatch):
    """``rgw_admin_usage.USAGE`` byte for byte, and every verb of
    ``rgw_admin.run`` in one script (keys and ids seeded, the gateway's
    clock faked as in the twins): equal exit codes, equal stdout and
    stderr, and equal stores."""
    import secrets
    import time

    from ceph_tpu.tools import rgw_admin_usage as j_usage
    from ceph_tpu_torch.tools import rgw_admin_usage as p_usage
    from torch_rbd_twin import fs_clock, seeded_token_hex
    assert p_usage.USAGE == j_usage.USAGE
    start = time.time()
    res = {}
    for pkg in (JAX, PORT):
        monkeypatch.setattr(secrets, "token_hex", seeded_token_hex())
        monkeypatch.setattr(time, "time", fs_clock(rgw_start=start))
        res[pkg] = _admin_run(pkg, capsys)
        monkeypatch.undo()
    assert res[PORT][0] == res[JAX][0]
    rcs = [rc for rc, _o, _e in res[PORT][0]]
    assert [i for i, rc in enumerate(rcs) if rc] == ADMIN_FAILS
    assert all(rc == 1 and err for rc, _o, err in
               (res[PORT][0][i] for i in ADMIN_FAILS))
    assert_same_state(res[JAX][1], res[PORT][1])


def test_rgw_admin_main_prints_usage(capsys):
    """``main`` with no verb, ``-h`` or ``--help`` prints the usage and
    exits 1 on both packages."""
    from ceph_tpu.tools import rgw_admin as j_admin
    from ceph_tpu_torch.tools import rgw_admin as p_admin
    for argv in ([], ["-h"], ["user", "--help"]):
        assert j_admin.main(argv) == 1
        j_out = capsys.readouterr().out
        assert p_admin.main(argv) == 1
        assert capsys.readouterr().out == j_out


# ---- the card's phase, rehearsed ------------------------------------------

def test_rgw_smoke_phase_rehearses_on_the_cpu(clean):
    """``chip_smoke.py``'s 4z at small sizes on the CPU (the data pool
    ``backend=host``): every leg runs over HTTP with v4-signed requests,
    every GET is byte-exact, the lifecycle pass removes each overwritten
    key's noncurrent version, the data pool then holds exactly the
    model's live chunks, and the degraded GETs cover chunks that lost a
    data shard."""
    import torch

    import chip_smoke
    out = chip_smoke.rgw_slice(
        torch.device("cpu"), big_objects=2, big_bytes=(4 << 20) + 100,
        small_objects=8, parts=2, part_bytes=3 << 20, overwrites=3,
        meta_pg_num=8, data_pg_num=8, trace_big=1, trace_small=2)
    legs = out["legs"]
    assert list(legs) == ["a_big_puts", "b_small_puts", "t_traced_sample",
                          "c_multipart", "d_versioning_lifecycle_gc",
                          "e_degraded_gets"]
    assert legs["a_big_puts"]["chunks"] == 4
    assert legs["c_multipart"]["chunks"] == 2 + 2
    d = legs["d_versioning_lifecycle_gc"]
    assert d["lifecycle"]["noncurrent_removed"] == 3
    assert d["gc"] == {"orphan_objects": 0, "stale_pending": 0}
    # 2 x 2 chunks, 8 small, 1 x 2 + 2 traced, 2 chunks of the upload
    assert d["data_objects"] == 4 + 8 + 4 + 2
    e = legs["e_degraded_gets"]
    assert e["objects"] == 2 + 8 + 3 + 1
    assert e["chunks_missing_a_data_shard"] > 0
    assert out["launches"] == {"gf_bit_matmul": 0}
