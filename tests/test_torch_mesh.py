"""The port's mesh runtime (``mesh/``) against the JAX package's, on the CPU.

JAX side: ``ceph_tpu.mesh`` on the 8 virtual CPU devices of
``tests/conftest.py``, with ``backend=tpu`` codecs (its device route).
Port side: ``ceph_tpu_torch.mesh`` on 8 CPU members
(``set_members_per_device(8)``) with ``backend=host`` codecs, whose
backend lives on the CPU mesh's platform.  The cases are
``tests/test_mesh.py``'s: mesh off by default, a one-member mesh as the
passthrough, byte identity of coalesced encode groups (with skew probes
on every flush), the decline of layout-transforming codecs, decode groups
on the mesh, the stored-shard cluster twin with every member occupied,
the plan cache and staging pool, donation on the CPU, the occupancy
histogram and the Prometheus families.  Every output is byte-equal
between the packages and to the single-device oracle; every counter
delta and ``dump()`` key set is equal.

By design the port has no fallback: with ``mesh.encode_batch`` armed the
flush raises to the dispatcher, which re-runs each request alone (its
own isolation, as for ``dispatch.batch``), and the mesh's ``fallbacks``
counter never moves, where JAX's guard degrades and counts.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.common.config import g_conf as jax_conf
from ceph_tpu.dispatch import g_dispatcher as jax_dispatcher
from ceph_tpu.ec.isa import ErasureCodeIsa as JaxIsa
from ceph_tpu.ec.jerasure import ErasureCodeJerasure as JaxJerasure
from ceph_tpu.ec.tpu_plugin import ErasureCodeTpu as JaxTpu
from ceph_tpu.fault import g_faults as jax_faults
from ceph_tpu.mesh import g_mesh as jax_mesh
from ceph_tpu.mesh import mesh_perf_counters as jax_mesh_pc
from ceph_tpu.osd import ecutil as jax_ecutil

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.dispatch import dispatch_perf_counters, g_dispatcher
from ceph_tpu_torch.ec.cuda_plugin import ErasureCodeCuda
from ceph_tpu_torch.ec.isa import ErasureCodeIsa
from ceph_tpu_torch.ec.jerasure import ErasureCodeJerasure
from ceph_tpu_torch.fault import InjectedDeviceError, g_faults
from ceph_tpu_torch.mesh import (g_mesh, mesh_decode_perf_counters,
                                 mesh_perf_counters, set_members_per_device)
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.trace import g_perf_histograms

from torch_daemon_twin import JAX, PORT, clean, set_both  # noqa: F401

set_members_per_device(8)

PC = {PORT: mesh_perf_counters, JAX: jax_mesh_pc}
DISPATCHER = {PORT: g_dispatcher, JAX: jax_dispatcher}
ECUTIL = {PORT: ecutil, JAX: jax_ecutil}
MESH = {PORT: g_mesh, JAX: jax_mesh}


def _mesh_on(chips=8, batch_max=64, window_us=10_000_000):
    set_both("ec_mesh_chips", chips)
    set_both("ec_dispatch_batch_window_us", window_us)
    set_both("ec_dispatch_batch_max", batch_max)


def _impls(kind, k, m, technique):
    """(port codec with backend=host, JAX codec on its device route)."""
    prof = {"k": str(k), "m": str(m), "technique": technique}
    port = {"cuda": ErasureCodeCuda, "isa": ErasureCodeIsa}[kind]()
    port.init({**prof, "backend": "host"})
    ref = {"cuda": JaxTpu, "isa": JaxIsa}[kind]()
    ref.init({**prof, "backend": "tpu"})
    return {PORT: port, JAX: ref}


def _deltas(before):
    return {pkg: {n: v - before[pkg].get(n, 0)
                  for n, v in PC[pkg]().dump().items()
                  if isinstance(v, (int, float))}
            for pkg in (PORT, JAX)}


def _snap():
    return {pkg: dict(PC[pkg]().dump()) for pkg in (PORT, JAX)}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for i in a:
        assert np.asarray(a[i]).tobytes() == np.asarray(b[i]).tobytes(), i


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def test_mesh_off_by_default_equal(clean):
    assert int(g_conf.get_val("ec_mesh_chips")) == 0
    assert g_mesh.active() is False and jax_mesh.active() is False
    pd, jd = g_dispatcher.dump()["mesh"], jax_dispatcher.dump()["mesh"]
    assert pd["active"] is False and pd["size"] == 0
    # the counters are process-global: earlier files of the worker moved
    # them, so the panes are held key for key and option for option
    assert _keys(pd) == _keys(jd)
    for key in ("options", "active", "size", "axis", "per_chip", "plans",
                "pool"):
        assert pd[key] == jd[key], key


def test_single_member_mesh_is_passthrough(clean):
    """ec_mesh_chips=1: a one-member topology never shards in either."""
    _mesh_on(chips=1)
    assert g_mesh.active() is False and jax_mesh.active() is False
    before = _snap()
    impls = _impls("cuda", 4, 2, "reed_sol_van")
    sinfo = {pkg: ECUTIL[pkg].stripe_info_t(4, 4 * 1024)
             for pkg in (PORT, JAX)}
    d = (np.arange(3 * 4 * 1024) % 251).astype(np.uint8)
    got = {pkg: DISPATCHER[pkg].submit_encode(
        sinfo[pkg], impls[pkg], d, set(range(6))).result()
        for pkg in (PORT, JAX)}
    _same(got[PORT], got[JAX])
    delta = _deltas(before)
    assert delta[PORT]["dispatches"] == delta[JAX]["dispatches"] == 0


MIX = [("cuda", 4, 2, "reed_sol_van"), ("cuda", 8, 4, "reed_sol_van"),
       ("isa", 3, 2, "cauchy"), ("isa", 6, 3, "reed_sol_van")]


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_mesh_byte_identity_equal(clean, seed):
    """Randomized (k, m, technique, chunk size, stripe count) mixes whose
    stripe totals are rarely a multiple of 8, skew probes on every
    flush: byte-equal between the packages and to the oracle, with equal
    mesh counter deltas."""
    set_both("ec_mesh_skew_sample_every", 1)
    rng = np.random.default_rng(seed)
    impls = [_impls(*spec) for spec in MIX]
    specs = []
    for _ in range(12):
        pair = impls[rng.integers(0, len(impls))]
        k, m = pair[PORT].k, pair[PORT].m
        chunk = int(rng.choice([512, 768, 1024, 1536]))
        stripes = int(rng.integers(1, 7))
        data = rng.integers(0, 256, size=stripes * k * chunk,
                            dtype=np.uint8)
        specs.append((pair, k, m, chunk, data))
    oracles = [ecutil.encode(ecutil.stripe_info_t(k, k * chunk), pair[PORT],
                             data, set(range(k + m)))
               for pair, k, m, chunk, data in specs]
    _mesh_on(chips=8)
    before = _snap()
    got = {}
    for pkg in (PORT, JAX):
        futs = [DISPATCHER[pkg].submit_encode(
            ECUTIL[pkg].stripe_info_t(k, k * chunk), pair[pkg], data,
            set(range(k + m))) for pair, k, m, chunk, data in specs]
        DISPATCHER[pkg].flush()
        got[pkg] = [f.result() for f in futs]
    for p, j, o in zip(got[PORT], got[JAX], oracles):
        _same(p, o)
        _same(j, o)
    delta = _deltas(before)
    assert delta[PORT]["dispatches"] > 0
    for name in ("dispatches", "reqs", "stripes", "pad_stripes", "bytes",
                 "plan_builds", "plan_hits", "fallbacks"):
        assert delta[PORT][name] == delta[JAX][name], name


def test_mesh_declines_layout_transforming_codecs_equal(clean):
    """Jerasure's bitmatrix layouts decline the mesh in both packages."""
    prof = {"k": "4", "m": "2", "technique": "cauchy_good",
            "packetsize": "8"}
    port = ErasureCodeJerasure()
    port.init({**prof, "backend": "host"})
    ref = JaxJerasure()
    ref.init({**prof, "backend": "tpu"})
    assert port.mesh_row_shardable is False is ref.mesh_row_shardable
    chunk = port._stripe_block() * 4
    rng = np.random.default_rng(31)
    data = rng.integers(0, 256, size=3 * 4 * chunk, dtype=np.uint8)
    oracle = ecutil.encode(ecutil.stripe_info_t(4, 4 * chunk), port, data,
                           set(range(6)))
    _mesh_on(chips=8)
    before = _snap()
    for pkg, impl in ((PORT, port), (JAX, ref)):
        f = DISPATCHER[pkg].submit_encode(
            ECUTIL[pkg].stripe_info_t(4, 4 * chunk), impl, data,
            set(range(6)))
        DISPATCHER[pkg].flush()
        _same(f.result(), oracle)
    delta = _deltas(before)
    assert delta[PORT]["dispatches"] == delta[JAX]["dispatches"] == 0


def test_decode_groups_ride_the_mesh_equal(clean):
    from ceph_tpu.mesh import mesh_decode_perf_counters as jax_mdec
    impls = _impls("cuda", 4, 2, "reed_sol_van")
    sinfo = ecutil.stripe_info_t(4, 4 * 1024)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=3 * 4 * 1024, dtype=np.uint8)
    shards = ecutil.encode(sinfo, impls[PORT], data, set(range(6)))
    chunks = {i: shards[i] for i in (0, 2, 4, 5)}
    _mesh_on(chips=8)
    m0 = {PORT: mesh_decode_perf_counters().dump()["dispatches"],
          JAX: jax_mdec().dump()["dispatches"]}
    for pkg in (PORT, JAX):
        si = ECUTIL[pkg].stripe_info_t(4, 4 * 1024)
        fe = DISPATCHER[pkg].submit_encode(si, impls[pkg], data,
                                           set(range(6)))
        fd = DISPATCHER[pkg].submit_decode_concat(si, impls[pkg],
                                                  dict(chunks))
        DISPATCHER[pkg].flush()
        _same(fe.result(), shards)
        assert np.asarray(fd.result()).tobytes() == data.tobytes()
    dp = mesh_decode_perf_counters().dump()["dispatches"] - m0[PORT]
    dj = jax_mdec().dump()["dispatches"] - m0[JAX]
    assert dp == dj > 0


def _ec_shard_bodies(c):
    out = {}
    for i, osd in c.osds.items():
        for cid in osd.store.list_collections():
            if "_meta" in cid or "s" not in cid.split(".")[-1]:
                continue
            for ho in osd.store.list_objects(cid):
                out[(i, cid, str(ho))] = bytes(osd.store.read(cid, ho))
    return out


POOL = {JAX: {"plugin": "tpu"},
        PORT: {"plugin": "cuda", "extra_profile": {"backend": "host"}}}
CLUSTER = {JAX: JaxCluster, PORT: PortCluster}


def _cluster_life(pkg, mesh: bool):
    if mesh:
        _mesh_on(chips=8, window_us=200_000)
    else:
        for name in ("ec_mesh_chips", "ec_dispatch_batch_max",
                     "ec_dispatch_batch_window_us"):
            g_conf.rm_val(name)
            jax_conf.rm_val(name)
    MESH[pkg].topology()
    c = CLUSTER[pkg](n_osds=6)
    c.create_ec_pool("mtwin", k=3, m=2, pg_num=4, **POOL[pkg])
    cl = c.client("client.mesh")
    rng = np.random.default_rng(99)
    expected = {}
    for i in range(3):
        body = bytes(rng.integers(0, 256, 9000 + 4111 * i, dtype=np.uint8))
        assert cl.write_full("mtwin", f"o{i}", body) == 0
        expected[f"o{i}"] = body
    before = {i: v["stripes"] for i, v in MESH[pkg].per_chip().items()}
    # 16 stripes (stripe_width = k * 4096): every member gets real rows
    big = bytes(np.random.default_rng(7).integers(
        0, 256, size=16 * 3 * 4096, dtype=np.uint8))
    assert cl.write_full("mtwin", "big", big) == 0
    expected["big"] = big
    occupancy = {i: v["stripes"] - before.get(i, 0)
                 for i, v in MESH[pkg].per_chip().items()}
    tail = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    assert cl.append("mtwin", "o1", tail) == 0
    expected["o1"] += tail
    for oid, body in expected.items():
        assert cl.read("mtwin", oid) == body, (pkg, mesh, oid)
    return c, _ec_shard_bodies(c), occupancy


def test_cluster_twin_stored_shards_equal(clean, monkeypatch):
    """A meshed port cluster stores shard bodies byte-equal to its
    single-device twin and to the meshed JAX cluster, puts real rows on
    every member of a 16-stripe write, renders the occupancy histogram
    and the mesh families on Prometheus, and adds no device sync."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    before = _snap()
    c, meshed, occ = _cluster_life(PORT, mesh=True)
    assert len(occ) == 8 and all(v > 0 for v in occ.values()), occ
    d = c.admin_socket.execute("dispatch dump")["mesh"]
    assert d["size"] == 8 and d["active"] is True
    assert all(d["per_chip"][i]["dispatches"] > 0 for i in d["per_chip"])
    hist = g_perf_histograms.get("dispatch",
                                 "dispatch_chip_occupancy_histogram")
    assert hist.total_count > 0
    assert [a.name for a in hist.axes] == ["chip_stripes", "chip_index"]
    prom = c.admin_socket.execute("prometheus metrics")
    for fam in ("ceph_daemon_mesh_dispatches", "ceph_daemon_mesh_stripes",
                "ceph_dispatch_chip_occupancy_histogram_bucket"):
        assert fam in prom
    jc, jmeshed, jocc = _cluster_life(JAX, mesh=True)
    assert occ == jocc
    delta = _deltas(before)
    for name in ("dispatches", "reqs", "stripes", "pad_stripes", "bytes"):
        assert delta[PORT][name] == delta[JAX][name] > 0, name
    _c, single, _o = _cluster_life(PORT, mesh=False)
    assert set(meshed) == set(single) == set(jmeshed)
    assert [k for k in single if meshed[k] != single[k]] == []
    assert [k for k in single if meshed[k] != jmeshed[k]] == []
    assert syncs == []


def test_plan_cache_and_pool_reuse_equal(clean):
    """Same signature and bucket share ONE plan, the second flush reuses
    the pooled staging buffer, a new bucket builds a second plan, the
    pool's capacity is live, and donation is off on the CPU (the option
    stays in the dump): equal in both packages."""
    _mesh_on(chips=8, batch_max=4)
    set_both("ec_mesh_donate", True)
    impls = _impls("cuda", 4, 2, "reed_sol_van")
    rng = np.random.default_rng(3)
    before = _snap()
    blobs = [rng.integers(0, 256, size=2 * 4 * 1024, dtype=np.uint8)
             for _ in range(8)]
    big = rng.integers(0, 256, size=4 * 4096, dtype=np.uint8)
    for pkg in (PORT, JAX):
        si = ECUTIL[pkg].stripe_info_t(4, 4 * 1024)
        for half in (blobs[:4], blobs[4:]):
            futs = [DISPATCHER[pkg].submit_encode(si, impls[pkg], b,
                                                  set(range(6)))
                    for b in half]
            for b, f in zip(half, futs):
                _same(f.result(), ecutil.encode(
                    ecutil.stripe_info_t(4, 4 * 1024), impls[PORT], b,
                    set(range(6))))
        DISPATCHER[pkg].submit_encode(
            ECUTIL[pkg].stripe_info_t(4, 4 * 4096), impls[pkg], big,
            set(range(6))).result()
    delta = _deltas(before)
    assert delta[PORT]["plan_builds"] == delta[JAX]["plan_builds"] == 2
    assert delta[PORT]["pool_hits"] == delta[JAX]["pool_hits"] >= 1
    pd, jd = g_mesh.dump(), jax_mesh.dump()
    assert _keys(pd) == _keys(jd)
    assert pd["options"] == jd["options"]
    assert pd["options"]["ec_mesh_donate"] is True
    assert len(pd["plans"]) == len(jd["plans"]) == 2
    assert all(p["donated"] is False for p in pd["plans"] + jd["plans"])
    assert pd["pool"] == jd["pool"]
    set_both("ec_mesh_pool_buffers", 1)
    g_mesh.topology()
    jax_mesh.topology()
    assert g_mesh.dump()["pool"]["per_shape"] == 1 == \
        jax_mesh.dump()["pool"]["per_shape"]


def test_encode_site_raises_to_the_dispatcher(clean):
    """By design: ``mesh.encode_batch`` raises out of the meshed flush;
    the dispatcher re-runs each request alone (byte-identical, its
    ``batch_fallbacks`` counted) and the mesh's ``fallbacks`` stays 0,
    where JAX's guard degrades the flush and counts a mesh fallback."""
    _mesh_on(chips=8)
    impls = _impls("cuda", 4, 2, "reed_sol_van")
    rng = np.random.default_rng(13)
    payloads = [rng.integers(0, 256, size=2 * 4 * 1024, dtype=np.uint8)
                for _ in range(3)]
    oracles = [ecutil.encode(ecutil.stripe_info_t(4, 4 * 1024),
                             impls[PORT], p, set(range(6)))
               for p in payloads]
    before = _snap()
    fb0 = dispatch_perf_counters().dump()["batch_fallbacks"]
    g_faults.inject("mesh.encode_batch", mode="always")
    futs = [g_dispatcher.submit_encode(ecutil.stripe_info_t(4, 4 * 1024),
                                       impls[PORT], p, set(range(6)))
            for p in payloads]
    g_dispatcher.flush()
    for f, o in zip(futs, oracles):
        _same(f.result(), o)
    assert dispatch_perf_counters().dump()["batch_fallbacks"] > fb0
    with pytest.raises(InjectedDeviceError):
        g_mesh.encode_stacked(impls[PORT],
                              [payloads[0].reshape(2, 4, 1024)], 1024)
    delta = _deltas(before)
    assert delta[PORT]["fallbacks"] == 0
    assert delta[PORT]["dispatches"] == 0
    jax_faults.inject("mesh.encode_batch", mode="always")
    futs = [jax_dispatcher.submit_encode(
        jax_ecutil.stripe_info_t(4, 4 * 1024), impls[JAX], p,
        set(range(6))) for p in payloads]
    jax_dispatcher.flush()
    for f, o in zip(futs, oracles):
        _same(f.result(), o)
    assert _deltas(before)[JAX]["fallbacks"] > 0
