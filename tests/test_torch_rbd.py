"""The port's ``rbd/`` against the JAX package's, on the CPU.

Every case of ``tests/test_rbd.py`` (image I/O, sparse reads, discard and
resize, snapshots, clones, copyup and flatten, the EC data pool, the
``rbd_cli`` verbs, ``du``), ``test_rbd_diff.py`` (diff export and import,
``cp``), ``test_rbd_exclusive_lock.py`` (the exclusive lock, the object
map and fast diff) and ``test_rbd_mirror.py`` (``ImageMirror`` and
``PoolMirror``) runs on both packages with the same inputs and
``uuid.uuid4`` drawn from one seeded sequence: each package's run passes
the case's own assertions, prints the same output, and every cluster the
case builds stores the same objects (image data, headers, the
``rbd_directory`` / ``rbd_children`` / journal omaps) on every OSD.  The
port's EC data pool runs ``backend=host``.
"""
import json

import pytest

import test_rbd
import test_rbd_diff
import test_rbd_exclusive_lock
import test_rbd_mirror
from torch_rbd_twin import (JAX, PORT, assert_same_runs, case_names,
                            port_module, run_both, seeded_uuid4)

MODULES = {m.__name__: m for m in (test_rbd, test_rbd_diff,
                                   test_rbd_exclusive_lock,
                                   test_rbd_mirror)}
PORTS = {name: port_module(m) for name, m in MODULES.items()}
CASES = [(mod, case) for mod, m in MODULES.items()
         for case in case_names(m)]


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}::{c}" for m, c in CASES])
def test_rbd_case_equal(mod, name, tmp_path, capsys):
    j, p = run_both(MODULES[mod], name, tmp_path, capsys,
                    port=PORTS[mod])
    assert j.clusters and all(j.states())
    assert_same_runs(j, p)


def _ec_image(pkg):
    """An image whose data lives on a k=2 m=1 EC pool, written past its
    objects' ends, snapshotted, cloned and written again (copyup)."""
    from importlib import import_module
    import uuid
    cluster = import_module(pkg + ".cluster")
    rbd = import_module(pkg + ".rbd")
    uuid.uuid4 = seeded_uuid4()
    c = cluster.MiniCluster(n_osds=4)
    c.create_replicated_pool("rbd", size=3, pg_num=8)
    prof = {"backend": "host"} if pkg == PORT else {}
    c.create_ec_pool("ecdata", k=2, m=1, plugin="isa", pg_num=8,
                     extra_profile=prof)
    cl = c.client("client.rbd")
    r = rbd.RBD(cl)
    r.create("rbd", "vm", 8 << 12, 12, data_pool="ecdata",
             journaling=True)
    img = rbd.Image(cl, "rbd", "vm")
    img.write(100, bytes(range(256)) * 40)
    img.write((3 << 12) - 7, b"z" * 15)
    img.snap_create("s1")
    img.snap_protect("s1")
    r.clone("rbd", "vm", "s1", "rbd", "child")
    child = rbd.Image(cl, "rbd", "child")
    child.write(5, b"copyup" * 10)
    out = {"stat": img.stat(), "child": child.stat(),
           "head": img.read(0, 8 << 12),
           "snap": rbd.Image(cl, "rbd", "vm", snapshot="s1").read(
               0, 8 << 12),
           "child_bytes": child.read(0, 8 << 12),
           "ls": r.list("rbd"),
           "omap_on_ec": cl.exec("ecdata", "rbd_header.x", "rbd",
                                 "get_image")}
    return out, c


def test_ec_data_pool_image_equal(clean_uuid):
    from torch_daemon_twin import store_state
    jo, jc = _ec_image(JAX)
    po, pc = _ec_image(PORT)
    assert json.dumps(po["stat"], sort_keys=True) == \
        json.dumps(jo["stat"], sort_keys=True)
    assert po == jo
    assert po["omap_on_ec"][0] == jo["omap_on_ec"][0] < 0
    ja, pa = store_state(jc), store_state(pc)
    assert pa == ja
    # the data objects sit on the EC pool as shards, the header on rbd
    ec_id = pc.mon.osdmap.lookup_pg_pool_name("ecdata")
    assert any(cid.startswith(f"{ec_id}.") and oid.startswith("rbd_data.")
               for (_osd, cid, oid, _shard) in pa)


@pytest.fixture
def clean_uuid(monkeypatch):
    import uuid
    from torch_daemon_twin import reset_both
    monkeypatch.setattr(uuid, "uuid4", uuid.uuid4)
    reset_both()
    yield
    reset_both()
