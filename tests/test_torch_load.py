"""The port's traffic harness (``load/``) against the JAX package's, on
the CPU.

One seed and one shape per case go through both packages' ``run_traffic``
on equal clusters: the deterministic tallies (ops completed, rounds,
bytes moved, byte-exactness, per-client issued / completed / throttled
and the round latency) are equal; wall-clock latencies are not compared.
The elastic-membership events change both meshes alike (8 CPU members on
the port's side, 8 virtual devices on JAX's).
"""
import pytest

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.load import TrafficSpec as JaxSpec
from ceph_tpu.load import run_traffic as jax_run

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.load import TrafficSpec as PortSpec
from ceph_tpu_torch.load import run_traffic as port_run

from torch_daemon_twin import JAX, PORT, clean  # noqa: F401

SIDES = {JAX: (JaxCluster, JaxSpec, jax_run, {"plugin": "tpu"}),
         PORT: (PortCluster, PortSpec, port_run,
                {"plugin": "cuda", "extra_profile": {"backend": "host"}})}
TALLY = ("issued", "completed", "throttled", "round_latency_max")


def run(pkg, pool_kind, **shape):
    cluster, spec, go, ec = SIDES[pkg]
    c = cluster(n_osds=8)
    if pool_kind == "ec":
        c.create_ec_pool("load", k=4, m=2, pg_num=8, **ec)
    else:
        c.create_replicated_pool("load", size=3, pg_num=8)
    res = go(c, spec(pool="load", seed=20261016, **shape))
    tallies = {name: {k: st[k] for k in TALLY}
               for name, st in res.per_client.items()}
    return (res.total_ops, res.completed, res.rounds, res.bytes_moved,
            res.byte_exact, res.throttled_total, res.admission_rejections,
            res.errors, tallies), c


@pytest.mark.parametrize("pool_kind,shape", [
    ("replicated", dict(n_clients=8, ops_per_client=16)),
    ("ec", dict(n_clients=6, ops_per_client=8,
                object_sizes=((4096, 0.5), (12288, 0.5)))),
    ("ec", dict(n_clients=4, ops_per_client=10, mode="open", rate=3.0,
                rate_multipliers=(4.0,), tick_every=4)),
    ("replicated", dict(n_clients=4, ops_per_client=8,
                        events=((2, "osd_kill", 3), (4, "osd_out", 3)))),
], ids=["replicated_closed", "ec_closed", "ec_open_abusive",
        "replicated_storm_events"])
def test_run_traffic_tallies_equal(clean, pool_kind, shape):
    (j, jc), (p, pc) = run(JAX, pool_kind, **shape), \
        run(PORT, pool_kind, **shape)
    assert p == j
    assert p[4] is True and p[1] == p[0]
    assert pc.health() == jc.health()
    assert pc.pg_states() == jc.pg_states()


def test_mesh_membership_events_equal(clean):
    """``mesh_chip_retire`` / ``mesh_chip_add`` under EC traffic move both
    packages' ``ec_mesh_chips`` and mesh through the same transitions:
    byte-exact tallies, equal membership counters and journal events;
    an unknown event raises in both."""
    from ceph_tpu.common.config import g_conf as jax_conf
    from ceph_tpu.mesh import g_mesh as jax_mesh
    from ceph_tpu.mesh.runtime import membership_perf_counters as jax_mpc
    from ceph_tpu.trace.journal import g_journal as jax_journal
    from ceph_tpu_torch.mesh import (g_mesh, membership_perf_counters,
                                     set_members_per_device)
    from ceph_tpu_torch.trace.journal import g_journal
    set_members_per_device(8)
    confs = {PORT: g_conf, JAX: jax_conf}
    meshes = {PORT: g_mesh, JAX: jax_mesh}
    mpcs = {PORT: membership_perf_counters, JAX: jax_mpc}
    journals = {PORT: g_journal, JAX: jax_journal}
    seen = {}
    try:
        for pkg in (JAX, PORT):
            confs[pkg].set_val("ec_mesh_chips", 8)
            confs[pkg].set_val("ec_dispatch_batch_window_us", 200_000)
            meshes[pkg].topology()
            before = dict(mpcs[pkg]().dump())
            res = run(pkg, "ec", n_clients=2, ops_per_client=6,
                      events=((1, "mesh_chip_retire", 3),
                              (3, "mesh_chip_add", 2)))[0]
            after = mpcs[pkg]().dump()
            seen[pkg] = (res, int(confs[pkg].get_val("ec_mesh_chips")),
                         meshes[pkg].topology().size,
                         {n: after[n] - before[n] for n in
                          ("transitions", "chip_adds", "chip_retires")},
                         [e["type"] for e in journals[pkg].merged()
                          if e["type"] in ("mesh_chip_add",
                                           "mesh_chip_retire")])
    finally:
        for pkg in (JAX, PORT):
            confs[pkg].rm_val("ec_mesh_chips")
            confs[pkg].rm_val("ec_dispatch_batch_window_us")
            meshes[pkg].topology()
    assert seen[PORT] == seen[JAX]
    res, chips, size, counts, events = seen[PORT]
    assert res[4] is True
    assert chips == size == 7
    assert counts == {"transitions": 2, "chip_adds": 2, "chip_retires": 3}
    assert events == ["mesh_chip_retire", "mesh_chip_add"]
    for pkg in (JAX, PORT):
        cluster, spec, go, _ec = SIDES[pkg]
        c = cluster(n_osds=4)
        c.create_replicated_pool("load", size=3, pg_num=8)
        with pytest.raises(ValueError, match="unknown traffic event"):
            go(c, spec(pool="load", n_clients=1, ops_per_client=1,
                       events=((0, "osd_explode", 1),)))
