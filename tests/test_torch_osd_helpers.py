"""The port's OSD helpers against the JAX package's, on the CPU: hit
sets, the snap mapper, object classes (``hello``, ``numops``, the lock
class) and the cache tier, alone and through both packages' daemons.

The port loads every object class the JAX package loads (``rbd`` and
``journal`` since the rbd slice, ``fs`` since the cephfs slice, ``rgw``
since the rgw slice): ``test_fs_and_rgw_classes_answer_as_jax`` pins
``fs`` and ``rgw`` on both sides, ``test_rbd_class_answers_as_jax`` the
ported ``rbd``.
"""
import numpy as np
import pytest

from ceph_tpu.osd import hit_set as j_hit_set
from ceph_tpu.osd import snap_mapper as j_snap_mapper
from ceph_tpu_torch.osd import hit_set as p_hit_set
from ceph_tpu_torch.osd import snap_mapper as p_snap_mapper

from torch_daemon_twin import clean  # noqa: F401 (a fixture)
from torch_daemon_twin import (JAX, PORT, assert_same_state,
                               store_state)



def test_hit_sets_match_jax(clean):
    names = [f"obj{i}" for i in range(300)]
    out = {}
    for mod in (p_hit_set, j_hit_set):
        h = mod.HitSetHistory(count=3)
        seen = []
        for i, n in enumerate(names):
            h.record(n)
            h.maybe_rotate(float(i), 40.0)
            seen.append(h.contains(names[(i * 7) % len(names)]))
        b = mod.BloomHitSet()
        for n in names[:50]:
            b.insert(n)
        enc = b.encode()
        again = mod.BloomHitSet.decode(enc)
        out[mod] = (seen, enc, [again.contains(n) for n in names])
    assert out[p_hit_set] == out[j_hit_set]


def test_snap_mapper_matches_jax(clean):
    rng = np.random.default_rng(4)
    snapsets = {f"o{i}": sorted({(int(a), int(a) + int(b))
                                 for a, b in rng.integers(1, 20, (3, 2))})
                for i in range(12)}
    out = {}
    for mod in (p_snap_mapper, j_snap_mapper):
        m = mod.SnapMapper()
        m.rebuild(snapsets, {3, 4})
        m.update_oid("o1", [(2, 9)], {5})
        purged = {1, 7, 300}
        out[mod] = ({s: sorted(m.lookup(s)) for s in range(25)},
                    mod.encode_purged(purged),
                    mod.decode_purged(mod.encode_purged(purged)))
    assert out[p_snap_mapper] == out[j_snap_mapper]


def _boot(pkg):
    import chip_smoke
    from torch_daemon_twin import profile
    d = chip_smoke.Daemons(pkg, 6)
    d.create_ec_pool("base", profile(pkg, k=2, m=1), 4)
    d.create_replicated_pool("rep", 3, 8)
    return d, d.client()


def test_object_classes_and_locks_match_jax(clean):
    out = {}
    for pkg in (JAX, PORT):
        d, cl = _boot(pkg)
        calls = [cl.exec("rep", "h", "hello", "say_hello", b"port"),
                 cl.exec("rep", "n", "numops", "add", b"5"),
                 cl.exec("rep", "n", "numops", "mul", b"3"),
                 cl.exec("rep", "n", "numops", "add", b"x"),
                 cl.exec("rep", "h", "hello", "no_such_method", b"")]
        locks = [cl.lock_exclusive("rep", "l", "lk", "c1", "me"),
                 cl.list_lockers("rep", "l", "lk"),
                 cl.unlock("rep", "l", "lk", "c1")]
        out[pkg] = (calls, locks, cl.read("rep", "n"),
                    store_state(d))
        d.shutdown()
    assert out[JAX][:3] == out[PORT][:3]
    assert out[PORT][2] == b"15"
    assert_same_state(out[JAX][3], out[PORT][3])


def test_fs_and_rgw_classes_answer_as_jax(clean):
    """``fs.mkfs``, ``fs.lookup`` and ``fs.mkfs`` again on a directory
    object: both OSDs run cls_fs and answer 0, -ENOENT, -EEXIST, and
    store the same object.  ``rgw.bucket_prepare_op`` on a bucket index:
    both OSDs run cls_rgw, answer 0 and store the same index object
    with its pending marker."""
    import json
    res = {}
    for pkg in (JAX, PORT):
        d, cl = _boot(pkg)
        fs = [cl.exec("rep", "fs.dir.1", "fs", "mkfs", b""),
              cl.exec("rep", "fs.dir.1", "fs", "lookup",
                      json.dumps({"name": "x"}).encode()),
              cl.exec("rep", "fs.dir.1", "fs", "mkfs", b"")]
        rgw = cl.exec("rep", "idx.b", "rgw", "bucket_prepare_op",
                      json.dumps({"tag": "t", "name": "o",
                                  "op": "put"}).encode())
        state = store_state(d)
        res[pkg] = (fs, rgw,
                    {k: v for k, v in state.items() if k[2] == "fs.dir.1"},
                    {k: v for k, v in state.items() if k[2] == "idx.b"})
        d.shutdown()
    assert res[PORT][0] == res[JAX][0] == [(0, b""), (-2, b""),
                                           (-17, b"")]
    assert res[PORT][2] and res[PORT][2] == res[JAX][2]
    assert res[PORT][1] == res[JAX][1] == (0, b"")
    assert res[PORT][3] and res[PORT][3] == res[JAX][3]


def test_rbd_class_answers_as_jax(clean):
    """``rbd.create`` then ``rbd.get_image`` on an image header: both
    OSDs run cls_rbd and answer 0 with the same header."""
    import json
    req = json.dumps({"size": 1 << 20, "object_prefix": "rbd_data.x"})
    res = {}
    for pkg in (JAX, PORT):
        d, cl = _boot(pkg)
        res[pkg] = ([cl.exec("rep", "rbd_header.x", "rbd", "create",
                             req.encode()),
                     cl.exec("rep", "rbd_header.x", "rbd", "get_image"),
                     cl.exec("rep", "rbd_header.x", "rbd", "create",
                             req.encode())],
                    store_state(d))
        d.shutdown()
    assert res[PORT][0] == res[JAX][0]
    assert res[PORT][0][0] == (0, b"")
    assert json.loads(res[PORT][0][1][1])["size"] == 1 << 20
    assert res[PORT][0][2][0] < 0
    assert_same_state(res[JAX][1], res[PORT][1])


def _agent(d, now):
    pid = d.mon.osdmap.lookup_pg_pool_name("hot")
    for osd in d.osds.values():
        for pgid, pg in list(osd.pgs.items()):
            if pgid[0] == pid and pg.is_primary() and pg.tier:
                pg.tier.agent_work(now)
    d.network.pump()


def test_cache_tier_matches_jax(clean):
    """Writes to an EC base land dirty in a replicated cache tier, the
    agent flushes them down when cold and evicts clean ones; a read
    miss promotes.  Both packages' OSDs store the same state."""
    out = {}
    for pkg in (JAX, PORT):
        d, cl = _boot(pkg)
        d.create_replicated_pool("hot", 3, 1)
        d.mon.add_cache_tier("base", "hot", hit_set_period=30.0,
                             hit_set_count=2, target_max_objects=2)
        d.publish()
        data = {f"obj{i}": bytes([i + 1]) * (3000 + i) for i in range(4)}
        for oid, body in data.items():
            assert cl.write_full("base", oid, body) == 0
        for now in (10.0, 50.0, 100.0, 150.0, 200.0, 250.0):
            _agent(d, now)
        for oid, body in data.items():
            assert cl.read("base", oid) == body, (pkg, oid)
        out[pkg] = store_state(d)
        d.shutdown()
    assert_same_state(out[JAX], out[PORT])
