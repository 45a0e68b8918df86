"""The port's ``MiniCluster`` against the JAX package's, on the CPU.

Both packages' clusters are built with the same sizes and seeds: 8 OSDs
(one per host) and an EC pool of k=4, m=2 with 8 PGs, so an OSD marked
out leaves its shards a home.  The JAX side runs ``plugin=tpu`` on its
CPU platform; the port ``plugin=cuda`` with ``backend=host`` (the kernels'
plain versions on CPU tensors).  A client writes, reads, loses an OSD to
a kill and the heartbeats, reads degraded, marks it out and recovers;
the stored bytes, ``pg_states`` and ``health`` text are equal at every
step, and ``checkpoint`` / ``restore`` brings the same bytes back.

The differences by design (ROADMAP Queue 3) are pinned here too: the
port has no codec breakers (no ``breaker dump``, no ``breakers_open``,
``TPU_CODEC_DEGRADED`` never raised).  Both collect the mesh's five
perf-counter families, and the chip probe reads a meshed flush on both.
"""
import pytest

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.fault import g_breakers as jax_breakers

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.mesh import g_chipstat

from torch_daemon_twin import (JAX, PORT, assert_same_state, clean,  # noqa: F401
                               payloads, store_state)

CLUSTERS = {JAX: JaxCluster, PORT: PortCluster}
POOL_ARGS = {JAX: {"plugin": "tpu"},
             PORT: {"plugin": "cuda", "extra_profile": {"backend": "host"}}}
# the mesh's perf-counter families, the chip scoreboard's included
MESH_FAMILIES = ("mesh", "mesh_chip", "mesh_decode", "mesh_membership",
                 "mesh_rateless")


@pytest.fixture(autouse=True)
def fresh_scoreboard():
    """The port's chip scoreboard is process-global: zero it around each
    test (the ``clean`` fixture resets the JAX one)."""
    g_chipstat.reset()
    yield
    g_chipstat.reset()


def boot(pkg, n_osds=8, pg_num=8):
    c = CLUSTERS[pkg](n_osds=n_osds)
    c.create_ec_pool("ec", k=4, m=2, pg_num=pg_num, **POOL_ARGS[pkg])
    return c, c.client()


def acting(c, cl, oid):
    """The acting set of ``oid``'s PG by the monitor's map."""
    from importlib import import_module
    pgid, _ = cl._calc_target(cl.lookup_pool("ec"), oid)
    pg_t = import_module(type(c).__module__.split(".")[0] + ".osdmap").pg_t
    return [int(o) for o in c.mon.osdmap.pg_to_up_acting_osds(
        pg_t(*pgid))[2]]


def life(pkg, objs):
    """One cluster's life: write, read, kill, ticks, degraded read, out,
    recovery.  Returns what each step shows."""
    c, cl = boot(pkg)
    seen = {}
    for oid, body in objs.items():
        assert cl.write_full("ec", oid, body) == 0
    for oid, body in objs.items():
        assert cl.read("ec", oid) == body
    seen["written"] = (store_state(c), c.pg_states(), c.health())
    victim = acting(c, cl, "obj0")[1]
    c.kill_osd(victim)
    c.tick(dt=6.0, rounds=6)
    seen["killed"] = (c.pg_states(), c.health())
    for oid, body in objs.items():
        assert cl.read("ec", oid) == body
    c.mark_osd_out(victim)
    c.tick(dt=1.0, rounds=2)
    for oid, body in objs.items():
        assert cl.read("ec", oid) == body
    seen["recovered"] = (store_state(c), c.pg_states(), c.health())
    seen["victim"] = victim
    seen["status_keys"] = sorted(c.admin_socket.execute("status"))
    return seen


def test_write_kill_degraded_read_out_recover_equal(clean):
    objs = payloads(6, seed=1601, base=3000, step=1111)
    j, p = life(JAX, objs), life(PORT, objs)
    assert p["victim"] == j["victim"]
    assert_same_state(p["written"][0], j["written"][0])
    assert p["written"][1:] == j["written"][1:]
    assert p["written"][2] == "HEALTH_OK"
    assert p["killed"] == j["killed"]
    assert "1 osds down" in p["killed"][1]
    assert_same_state(p["recovered"][0], j["recovered"][0])
    assert p["recovered"][1:] == j["recovered"][1:]
    assert set(p["recovered"][1].values()) == {"active"}
    assert p["status_keys"] == j["status_keys"]


def test_checkpoint_restore_brings_the_same_bytes_back(clean, tmp_path):
    objs = payloads(4, seed=1602, base=5000, step=777)
    seen = {}
    for pkg in (JAX, PORT):
        c, cl = boot(pkg)
        for oid, body in objs.items():
            assert cl.write_full("ec", oid, body) == 0
        before = store_state(c)
        d = tmp_path / pkg
        c.checkpoint(str(d))
        r = CLUSTERS[pkg].restore(str(d))
        rcl = r.client("client.restored")
        for oid, body in objs.items():
            assert rcl.read("ec", oid) == body
        after = store_state(r)
        assert after.keys() == before.keys()
        seen[pkg] = (after, r.pg_states(), r.health(),
                     sorted(p.name for p in d.iterdir()))
    assert_same_state(seen[PORT][0], seen[JAX][0])
    assert seen[PORT][1:] == seen[JAX][1:]


def test_create_ec_pool_defaults_to_the_cuda_plugin(clean):
    c = PortCluster(n_osds=6)
    c.create_ec_pool("d", k=2, m=1, pg_num=4,
                     extra_profile={"backend": "host"})
    prof = c.mon.osdmap.erasure_code_profiles["d_profile"]
    assert prof["plugin"] == "cuda"
    j = JaxCluster(n_osds=6)
    j.create_ec_pool("d", k=2, m=1, pg_num=4)
    assert j.mon.osdmap.erasure_code_profiles["d_profile"]["plugin"] == "tpu"


def test_no_breaker_surfaces_in_the_port(clean):
    """Queue 3, by design: the port has no codec circuit breakers."""
    p, _ = boot(PORT)
    j, _ = boot(JAX)
    with pytest.raises(KeyError):
        p.admin_socket.execute("breaker dump")
    assert isinstance(j.admin_socket.execute("breaker dump"), (dict, list))
    assert "breakers_open" not in p.tpu_status()
    assert set(j.tpu_status()) - set(p.tpu_status()) == {"breakers_open"}
    # a stale check (none can be raised in the port) is dropped, and the
    # check never raises
    p.mgr.health_checks["TPU_CODEC_DEGRADED"] = "stale"
    p.mgr.check_degraded_codecs()
    p.tick(dt=1.0, rounds=2)
    assert "TPU_CODEC_DEGRADED" not in p.mgr.health_checks
    assert "TPU_CODEC_DEGRADED" not in p.health()
    assert "ceph_tpu_codec" not in p.admin_socket.execute(
        "prometheus metrics")
    assert not jax_breakers.degraded()


def test_perf_collection_carries_the_mesh_families(clean):
    """Both clusters collect the mesh's five counter families, with the
    same counters in each."""
    p, _ = boot(PORT)
    j, _ = boot(JAX)
    pd, jd = p.perf_collection.dump(), j.perf_collection.dump()
    assert set(pd) == set(jd)
    for fam in MESH_FAMILIES:
        assert pd[fam].keys() == jd[fam].keys(), fam


def test_chip_probe_reads_a_meshed_flush(clean):
    """``ChipStat.probe`` polls each member's piece of a meshed flush and
    records one delta per member, as JAX's does per shard; ``mesh skew
    dump`` answers as JAX's does."""
    from ceph_tpu.common.config import g_conf as jax_conf
    from ceph_tpu.mesh import g_chipstat as jax_chipstat
    from ceph_tpu.mesh import g_mesh as jax_mesh
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.mesh import g_mesh, set_members_per_device
    set_members_per_device(8)
    p, pcl = boot(PORT)
    j, jcl = boot(JAX)
    for conf in (g_conf, jax_conf):
        conf.set_val("ec_mesh_chips", 8)
        conf.set_val("ec_mesh_skew_sample_every", 1)
        conf.set_val("ec_dispatch_batch_window_us", 200_000)
    body = payloads(1, 5, base=8 * 4 * 4096)["obj0"]
    try:
        for c, cl, stat in ((p, pcl, g_chipstat), (j, jcl, jax_chipstat)):
            stat.reset()
            assert cl.write_full("ec", "probed", body) == 0
            assert cl.read("ec", "probed") == body
            summary = stat.summary()
            assert summary["probes"] >= 1
            assert len(summary["per_chip"]) == 8
        pd = p.admin_socket.execute("mesh skew dump")
        jd = j.admin_socket.execute("mesh skew dump")
        assert pd.keys() == jd.keys()
        assert pd["probes"] == jd["probes"]
        assert pd["counters"]["samples"] == jd["counters"]["samples"]
    finally:
        for conf in (g_conf, jax_conf):
            for name in ("ec_mesh_chips", "ec_mesh_skew_sample_every",
                         "ec_dispatch_batch_window_us"):
                conf.rm_val(name)
        g_mesh.topology()
        jax_mesh.topology()


def test_osd_tick_kicks_the_chip_scoreboard(clean, monkeypatch):
    """The OSD tick carries the JAX tick's ``g_chipstat.tick_kick()``:
    with sampling on and a flush since the last probe, the next flush
    is armed to probe."""
    from ceph_tpu_torch.common.config import g_conf
    kicks = []
    orig = g_chipstat.tick_kick
    monkeypatch.setattr(g_chipstat, "tick_kick",
                        lambda: (kicks.append(1), orig())[1])
    p, _ = boot(PORT)
    p.tick(dt=1.0)
    assert len(kicks) == len(p.osds)
    g_conf.set_val("ec_mesh_skew_sample_every", 4)
    g_chipstat.should_probe()          # one flush, not the 4th
    assert not g_chipstat._force_probe
    p.tick(dt=1.0)
    assert g_chipstat._force_probe
    assert g_chipstat.should_probe()
