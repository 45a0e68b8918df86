"""The port's OSD data path against the JAX package's, on the CPU.

A client's ``write_full``, partial overwrites (rmw), appends and ranged
reads go through the port's ``RadosClient``, OSD, PG and ``ECBackend``
(``plugin=cuda, backend=host``: K1, K4 and K5 run their plain PyTorch
versions) and through the JAX package's twin daemons (``plugin=tpu`` on
its CPU platform), built the same way by ``chip_smoke.Daemons``.  What
the OSDs store must be equal, object by object: shard bodies, every
attribute (``SIZE_ATTR``, ``HINFO_ATTR``, ``VERSION_ATTR``, ...) and the
PG meta objects' omap (the PG log).  Degraded reads after two OSDs go
down are byte-exact, recovery after ``mark_osd_out`` rebuilds equal
shards, scrub finds the same inconsistencies, the resident write stores
what the JAX resident write stores, and the pipelined, coalesced and
threaded write path stores what the synchronous one does.
"""
import numpy as np
import pytest

from torch_daemon_twin import clean  # noqa: F401 (a fixture)
from torch_daemon_twin import (JAX, PORT, assert_same_state, boot,
                               payloads, set_both, shard_holders,
                               store_state)


POOL = "ecpool"
STRIPE = 4 * 4096                 # k=4 at the monitor's 4096-byte unit


def _writes(pkg, objs):
    d, cl = boot(pkg)
    for oid, body in objs.items():
        assert cl.write_full(POOL, oid, body) == 0, (pkg, oid)
    return d, cl


def _rmw(cl, expected, rng):
    """A partial overwrite inside one object, one across a stripe
    boundary, an append and an overwrite of a whole object."""
    ops = [("write", "obj1", 1234, 5000), ("write", "obj2", STRIPE - 100,
                                           300),
           ("append", "obj3", 0, 7000), ("write_full", "obj0", 0, 3000)]
    for kind, oid, off, n in ops:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        if kind == "write":
            assert cl.write(POOL, oid, data, off) == 0
            b = bytearray(expected[oid])
            b[off:off + n] = data
            expected[oid] = bytes(b)
        elif kind == "append":
            assert cl.append(POOL, oid, data) == 0
            expected[oid] += data
        else:
            assert cl.write_full(POOL, oid, data) == 0
            expected[oid] = data


def test_write_rmw_append_store_what_jax_stores(clean):
    objs = payloads(6, seed=1)
    states, reads = {}, {}
    for pkg in (JAX, PORT):
        d, cl = _writes(pkg, objs)
        expected = dict(objs)
        _rmw(cl, expected, np.random.default_rng(2))
        for oid, body in expected.items():
            assert cl.read(POOL, oid) == body, (pkg, oid)
        reads[pkg] = [cl.read(POOL, "obj4", 777, 9000),
                      cl.read(POOL, "obj2", STRIPE - 50, 200),
                      cl.read(POOL, "obj1", 0, 64)]
        assert reads[pkg][0] == expected["obj4"][777:777 + 9000]
        assert reads[pkg][1] == expected["obj2"][STRIPE - 50:STRIPE + 150]
        states[pkg] = store_state(d)
        d.shutdown()
    assert reads[JAX] == reads[PORT]
    assert_same_state(states[JAX], states[PORT])


def _down(d, cl, victims):
    for o in victims:
        d.kill_osd(o)
    for _ in range(6):
        d.tick(6.0)
        if all(not d.mon.osdmap.is_up(o) for o in victims):
            break
    assert all(not d.mon.osdmap.is_up(o) for o in victims)


def test_degraded_read_and_recovery_match_jax(clean):
    """Two OSDs down: every object reads back byte-exact.  Then one of
    them is marked out and recovery rebuilds its shards elsewhere: the
    live OSDs store what the JAX twin's store."""
    objs = payloads(8, seed=3)
    states = {}
    for pkg in (JAX, PORT):
        d, cl = _writes(pkg, objs)
        holders = shard_holders(d, cl, POOL, "obj0")
        victims = [holders[1], holders[4]]
        _down(d, cl, victims)
        for oid, body in objs.items():
            assert cl.read(POOL, oid) == body, (pkg, oid)
            assert cl.read(POOL, oid, 1000, 3000) == body[1000:4000]
        d.mark_osd_out(victims[0])
        d.run_recovery()
        for oid, body in objs.items():
            assert cl.read(POOL, oid) == body, (pkg, oid)
        states[pkg] = {k: v for k, v in store_state(d).items()
                       if k[0] not in victims}
        d.shutdown()
    assert_same_state(states[JAX], states[PORT])


def _corrupt(d, oid, shard, byte=7):
    for osd in d.osds.values():
        for cid in osd.store.list_collections():
            for ho in osd.store.list_objects(cid):
                if ho.oid == oid and ho.shard == shard:
                    osd.store.colls[cid][ho].data[byte] ^= 0x5A
                    return osd.osd_id
    raise AssertionError(f"no shard {shard} of {oid}")


def test_scrub_finds_what_jax_finds(clean):
    objs = payloads(4, seed=4)
    found, states = {}, {}
    for pkg in (JAX, PORT):
        d, cl = _writes(pkg, objs)
        _corrupt(d, "obj1", 2)
        _corrupt(d, "obj3", 5, byte=100)
        for osd in d.osds.values():
            for pg in osd.pgs.values():
                if pg.is_primary():
                    pg.start_scrub(deep=True)
        d.network.pump()
        found[pkg] = sorted(
            (pgid, shard, oid)
            for osd in d.osds.values() for pgid, pg in osd.pgs.items()
            if pg.is_primary()
            for shard, mm in pg.missing.items() for oid in mm)
        d.run_recovery()
        for oid, body in objs.items():
            assert cl.read(POOL, oid) == body
        states[pkg] = store_state(d)
        d.shutdown()
    assert len(found[PORT]) == 2
    assert found[JAX] == found[PORT]
    assert_same_state(states[JAX], states[PORT])


def test_resident_write_stores_what_jax_stores(clean):
    """Residency on (``os_memstore_device_bytes_max`` > 0): whole-stripe
    writes keep their bodies as ``DeviceShard`` handles (K5's plain
    version here), reads verify them with the device crc (K4's plain
    version: ``crc_device`` moves, ``crc_host`` does not), and a body
    rotted at the ``store.shard_corrupt`` fault site fails its sub-read
    alone while the client still reads the right bytes."""
    import importlib
    from ceph_tpu_torch.os_store import DeviceShard
    from ceph_tpu_torch.os_store.device_shard import (
        l_msd_crc_device, l_msd_crc_host, memstore_device_perf_counters)
    set_both("os_memstore_device_bytes_max", 1 << 26)
    rng = np.random.default_rng(5)
    objs = {f"obj{i}": rng.integers(0, 256, STRIPE * (i + 1),
                                    dtype=np.uint8).tobytes()
            for i in range(4)}
    states = {}
    for pkg in (JAX, PORT):
        d, cl = _writes(pkg, objs)
        if pkg == PORT:
            bodies = [osd.store.read_shard(cid, ho)
                      for osd in d.osds.values()
                      for cid in osd.store.list_collections()
                      for ho in osd.store.list_objects(cid)
                      if ho.shard >= 0]
            assert len(bodies) == 6 * len(objs)
            assert all(isinstance(b, DeviceShard) for b in bodies)
            pc = memstore_device_perf_counters()
            dev0, host0 = pc.get(l_msd_crc_device), pc.get(l_msd_crc_host)
        for oid, body in objs.items():
            assert cl.read(POOL, oid) == body, (pkg, oid)
        if pkg == PORT:
            assert pc.get(l_msd_crc_device) - dev0 == 4 * len(objs)
            assert pc.get(l_msd_crc_host) == host0
        holders = shard_holders(d, cl, POOL, "obj2")
        st = d.osds[holders[0]].store
        cid = next(c for c in st.list_collections()
                   if any(h.oid == "obj2" for h in st.list_objects(c)))
        ho = next(h for h in st.list_objects(cid) if h.oid == "obj2")
        faults = importlib.import_module(pkg + ".fault").g_faults
        faults.inject("store.shard_corrupt", mode="once",
                      match=f"{cid}/{ho}")
        try:
            assert cl.read(POOL, "obj2") == objs["obj2"], pkg
        finally:
            faults.clear()
        states[pkg] = store_state(d)
        d.shutdown()
    assert_same_state(states[JAX], states[PORT])


def test_walstore_refuses_a_resident_body_in_both(clean, tmp_path):
    """A mounted ``WALStore`` has no journal code for ``write_shard``: an
    OSD on one with residency on fails the write with ``KeyError`` in
    both packages (ROADMAP Queue 3), before anything is applied."""
    import importlib
    import chip_smoke
    from torch_daemon_twin import profile
    set_both("os_memstore_device_bytes_max", 1 << 26)
    body = np.random.default_rng(6).integers(
        0, 256, 2 * STRIPE, dtype=np.uint8).tobytes()
    for pkg in (JAX, PORT):
        ws = importlib.import_module(pkg + ".os_store.walstore")
        stores = {i: ws.mount_store(str(tmp_path / pkg / f"osd{i}"))
                  for i in range(7)}
        d = chip_smoke.Daemons(pkg, 7, stores=stores)
        d.create_ec_pool(POOL, profile(pkg), 16)
        cl = d.client()
        with pytest.raises(KeyError):
            cl.write_full(POOL, "obj", body)
        d.shutdown()


def test_pipelined_threaded_writes_store_what_sync_stores(clean):
    """Depth 8 with a collection window, four op threads and burst
    intake: one burst of 24 writes from many PGs gets every reply, at
    least one flush coalesces more than one request, and the stores
    equal the JAX twin's under the same options and a synchronous run
    of the port."""
    from ceph_tpu_torch.dispatch import dispatch_perf_counters
    from ceph_tpu_torch.dispatch.scheduler import l_dispatch_coalesced
    objs = payloads(24, seed=7, base=4 * STRIPE, step=0)
    states = {}
    sync, _ = _writes(PORT, objs)
    states["sync"] = store_state(sync)
    sync.shutdown()
    for name, v in (("ec_pipeline_depth", 8),
                    ("ec_dispatch_batch_window_us", 200_000),
                    ("osd_op_num_threads", 4),
                    ("osd_op_queue_batch_intake", True)):
        set_both(name, v)
    for pkg in (JAX, PORT):
        d, cl = boot(pkg)
        c0 = dispatch_perf_counters().get(l_dispatch_coalesced)
        res = d.burst_write_full(cl, POOL, objs)
        assert res == {oid: 0 for oid in objs}, (pkg, res)
        if pkg == PORT:
            assert dispatch_perf_counters().get(l_dispatch_coalesced) > c0
        for oid, body in objs.items():
            assert cl.read(POOL, oid) == body, (pkg, oid)
        states[pkg] = store_state(d)
        d.shutdown()
    assert_same_state(states[JAX], states[PORT])
    assert_same_state(states["sync"], states[PORT])


def test_pg_mapping_memo_follows_every_epoch(clean):
    """The port's OSD maps each PG through CRUSH once per epoch
    (``OSD.pg_mapping``), where the JAX OSD asks its map on every call:
    after each map change every live OSD's memo equals what its own map
    and the JAX twin's map give, and a caller that edits the lists it
    got changes neither the memo nor the other list."""
    from ceph_tpu.osdmap import pg_t as j_pg_t
    from ceph_tpu_torch.osdmap import pg_t
    ds = {pkg: boot(pkg, pg_num=16)[0] for pkg in (JAX, PORT)}
    pool = ds[PORT].mon.osdmap.lookup_pg_pool_name(POOL)

    def check():
        port, jax = ds[PORT], ds[JAX]
        assert port.mon.osdmap.epoch == jax.mon.osdmap.epoch
        for i, osd in port.osds.items():
            if osd.name in port.network.down:
                continue
            for ps in range(16):
                got = osd.pg_mapping((pool, ps))
                raw = osd.osdmap.pg_to_up_acting_osds(pg_t(pool, ps))
                assert got == raw
                assert got == jax.osds[i].osdmap.pg_to_up_acting_osds(
                    j_pg_t(pool, ps))
                assert (got[0] is got[2]) == (raw[0] is raw[2])
                got[0].append(-7)
                got[2].append(-8)
                again = osd.pg_mapping((pool, ps))
                assert again == raw

    check()
    for step in ("kill", "out", "in"):
        for d in ds.values():
            if step == "kill":
                d.kill_osd(2)
                d.mark_osd_down(2)
            elif step == "out":
                d.mark_osd_out(2)
            else:
                d.revive_osd(2)
                d.mark_osd_in(2)
        check()
    for d in ds.values():
        d.shutdown()
