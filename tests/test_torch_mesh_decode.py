"""The port's meshed READ path against the JAX package's, on the CPU.

JAX side: ``ceph_tpu.mesh`` on the 8 virtual CPU devices of
``tests/conftest.py`` with ``backend=tpu`` codecs; port side: 8 CPU
members (``set_members_per_device(8)``) with ``backend=host`` codecs.
The cases are ``tests/test_mesh_decode.py``'s: the mesh off and a
one-member mesh as passthroughs, the decline of layout-transforming
decodes, byte identity of meshed reconstruction on the SPMD and the
rateless branch, the decode plan cache, the regenerating family's ≥d
decode and folded repair solve, a dead chip and a straggler completed
from the spanning subset, an elastic-membership transition in the middle
of queued decodes, and the degraded-read cluster twin.  Outputs are
byte-equal between the packages and to the encoded truth; deterministic
counter deltas are equal.

By design: the ``mesh.decode_batch`` site raises to the caller of
``decode_batch`` and the mesh's ``fallbacks`` stays 0, where JAX's guard
degrades the group to one device, counts a fallback and journals
``mesh_decode_degraded``.
"""
import numpy as np
import pytest

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.common.config import g_conf as jax_conf
from ceph_tpu.dispatch import g_dispatcher as jax_dispatcher
from ceph_tpu.ec.isa import ErasureCodeIsa as JaxIsa
from ceph_tpu.ec.jerasure import ErasureCodeJerasure as JaxJerasure
from ceph_tpu.ec.regenerating import ErasureCodeRegenerating as JaxRegen
from ceph_tpu.ec.tpu_plugin import ErasureCodeTpu as JaxTpu
from ceph_tpu.fault import g_faults as jax_faults
from ceph_tpu.mesh import g_mesh as jax_mesh
from ceph_tpu.mesh import mesh_decode_perf_counters as jax_mdec_pc
from ceph_tpu.mesh import rateless_perf_counters as jax_rl_pc
from ceph_tpu.mesh.runtime import membership_perf_counters as jax_member_pc
from ceph_tpu.osd import ecutil as jax_ecutil
from ceph_tpu.trace.journal import g_journal as jax_journal

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.dispatch import g_dispatcher
from ceph_tpu_torch.ec.cuda_plugin import ErasureCodeCuda
from ceph_tpu_torch.ec.isa import ErasureCodeIsa
from ceph_tpu_torch.ec.jerasure import ErasureCodeJerasure
from ceph_tpu_torch.ec.regenerating import ErasureCodeRegenerating
from ceph_tpu_torch.fault import InjectedDeviceError, g_faults
from ceph_tpu_torch.mesh import (g_mesh, membership_perf_counters,
                                 mesh_decode_perf_counters,
                                 rateless_perf_counters,
                                 set_members_per_device)
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.trace.journal import g_journal

from torch_daemon_twin import JAX, PORT, clean, set_both  # noqa: F401

set_members_per_device(8)

BOTH = (PORT, JAX)
DISPATCHER = {PORT: g_dispatcher, JAX: jax_dispatcher}
ECUTIL = {PORT: ecutil, JAX: jax_ecutil}
MESH = {PORT: g_mesh, JAX: jax_mesh}
FAULTS = {PORT: g_faults, JAX: jax_faults}
MDEC = {PORT: mesh_decode_perf_counters, JAX: jax_mdec_pc}
RL = {PORT: rateless_perf_counters, JAX: jax_rl_pc}
MEMBER = {PORT: membership_perf_counters, JAX: jax_member_pc}
CLUSTER = {PORT: PortCluster, JAX: JaxCluster}
POOL = {JAX: {"plugin": "tpu"},
        PORT: {"plugin": "cuda", "extra_profile": {"backend": "host"}}}
BACKEND = {PORT: "host", JAX: "tpu"}
CONF = {PORT: g_conf, JAX: jax_conf}


def _mesh_on(chips=8, rateless=False):
    set_both("ec_mesh_chips", chips)
    if rateless:
        set_both("ec_mesh_rateless", True)


def _impls(kind="cuda", k=4, m=2, technique="reed_sol_van", **extra):
    out = {}
    for pkg in BOTH:
        cls = {("cuda", PORT): ErasureCodeCuda, ("cuda", JAX): JaxTpu,
               ("isa", PORT): ErasureCodeIsa, ("isa", JAX): JaxIsa,
               ("jerasure", PORT): ErasureCodeJerasure,
               ("jerasure", JAX): JaxJerasure,
               ("regen", PORT): ErasureCodeRegenerating,
               ("regen", JAX): JaxRegen}[(kind, pkg)]
        impl = cls()
        impl.init({"k": str(k), "m": str(m), "technique": technique,
                   "backend": BACKEND[pkg], **extra})
        out[pkg] = impl
    return out


def _encode_stacked(impl, rng, stripes, chunk):
    """Every shard of a random payload as its (S, C) stack, through the
    port's host oracle: the truth any reconstruction must reproduce."""
    k, m = impl.k, impl.m
    payload = rng.integers(0, 256, size=stripes * k * chunk, dtype=np.uint8)
    shards = ecutil.encode(ecutil.stripe_info_t(k, k * chunk), impl,
                           payload, set(range(k + m)))
    return {i: np.ascontiguousarray(np.asarray(b).reshape(stripes, chunk))
            for i, b in shards.items()}


def _snap(fam):
    return {pkg: dict(fam[pkg]().dump()) for pkg in BOTH}


def _delta(fam, before, names):
    return {pkg: {n: fam[pkg]().dump()[n] - before[pkg][n] for n in names}
            for pkg in BOTH}


def test_mesh_off_decode_is_passthrough_equal(clean):
    impls = _impls()
    full = _encode_stacked(impls[PORT], np.random.default_rng(3), 4, 1024)
    survivors = np.stack([full[i] for i in (0, 2, 3, 4)], axis=1)
    before = _snap(MDEC)
    for chips in (0, 1):
        set_both("ec_mesh_chips", chips)
        for pkg in BOTH:
            assert MESH[pkg].active() is False
            assert MESH[pkg].decode_stacked(impls[pkg], survivors,
                                            (0, 2, 3, 4), (1,)) is None
            got = impls[pkg].decode_batch({i: full[i] for i in (0, 2, 3, 4)},
                                          [1])
            assert np.array_equal(got[1], full[1])
    assert _delta(MDEC, before, ("dispatches",)) == \
        {PORT: {"dispatches": 0}, JAX: {"dispatches": 0}}


def test_mesh_declines_non_shardable_decode_equal(clean):
    impls = _impls("jerasure", technique="cauchy_good", packetsize="8")
    assert impls[PORT].mesh_decode_shardable is False
    assert impls[JAX].mesh_decode_shardable is False
    _mesh_on()
    before = _snap(MDEC)
    full = _encode_stacked(impls[PORT], np.random.default_rng(17), 2,
                           impls[PORT]._stripe_block() * 2)
    for pkg in BOTH:
        got = impls[pkg].decode_batch({i: full[i] for i in (0, 2, 3, 4)},
                                      [1])
        assert np.array_equal(got[1], full[1])
    assert _delta(MDEC, before, ("dispatches",)) == \
        {PORT: {"dispatches": 0}, JAX: {"dispatches": 0}}


MIX = [("cuda", 4, 2, "reed_sol_van"), ("cuda", 8, 4, "reed_sol_van"),
       ("isa", 3, 2, "cauchy"), ("isa", 6, 3, "reed_sol_van")]


@pytest.mark.parametrize("seed,rateless", [(11, False), (23, True)])
def test_meshed_decode_byte_identity_equal(clean, seed, rateless):
    _mesh_on(rateless=rateless)
    rng = np.random.default_rng(seed)
    pairs = [_impls(*spec) for spec in MIX]
    before = _snap(MDEC)
    for _ in range(8):
        pair = pairs[rng.integers(0, len(pairs))]
        k, m = pair[PORT].k, pair[PORT].m
        chunk = int(rng.choice([512, 1024, 1536]))
        stripes = int(rng.integers(1, 7))
        full = _encode_stacked(pair[PORT], rng, stripes, chunk)
        n_lost = int(rng.integers(1, m + 1))
        lost = [int(rng.integers(0, k))]
        lost += [int(i) for i in rng.choice(
            [i for i in range(k + m) if i != lost[0]],
            size=n_lost - 1, replace=False)]
        chunks = {i: full[i] for i in range(k + m) if i not in lost}
        for pkg in BOTH:
            got = pair[pkg].decode_batch(dict(chunks), lost)
            for i in lost:
                assert np.array_equal(got[i], full[i]), (pkg, k, m, lost, i)
    delta = _delta(MDEC, before, ("dispatches", "stripes", "pad_stripes",
                                  "bytes", "col_folds", "fallbacks"))
    assert delta[PORT] == delta[JAX]
    assert delta[PORT]["dispatches"] > 0 and delta[PORT]["fallbacks"] == 0


def test_decode_plan_cache_reuses_equal(clean):
    _mesh_on()
    impls = _impls()
    before = _snap(MDEC)
    rng = np.random.default_rng(29)
    for _ in range(2):
        full = _encode_stacked(impls[PORT], rng, 4, 1024)
        for pkg in BOTH:
            got = impls[pkg].decode_batch({i: full[i] for i in (0, 2, 3, 4)},
                                          [1])
            assert np.array_equal(got[1], full[1])
    delta = _delta(MDEC, before, ("plan_builds", "plan_hits"))
    assert delta[PORT] == delta[JAX]
    assert delta[PORT]["plan_builds"] == 1 and delta[PORT]["plan_hits"] >= 1
    rows = {pkg: [p for p in MESH[pkg].dump()["plans"]
                  if p.get("kind") == "decode"] for pkg in BOTH}
    assert rows[PORT] == rows[JAX]
    assert rows[PORT][0]["srcs"] == [0, 2, 3, 4]
    assert rows[PORT][0]["want_rows"] == [1]


def test_meshed_regenerating_decode_and_repair_equal(clean):
    """pm_mbr and pm_msr: the ≥d decode and the folded d×d repair solve
    ride both meshes byte-exactly, with equal counter deltas."""
    _mesh_on(rateless=True)
    before = _snap(MDEC)
    rng = np.random.default_rng(11)
    for tech, m in (("pm_mbr", 2), ("pm_msr", 3)):
        impls = _impls("regen", m=m, technique=tech)
        r = impls[PORT]
        n = r.k + r.m
        sw = r.preferred_stripe_width()
        payload = rng.integers(0, 256, size=2 * sw, dtype=np.uint8)
        shards = ecutil.encode(r.make_stripe_info(sw), r, payload,
                               set(range(n)))
        stacked = {i: np.ascontiguousarray(np.asarray(b).reshape(2, -1))
                   for i, b in shards.items()}
        missing = 1
        sub = {i: b for i, b in stacked.items() if i != missing}
        helpers = [i for i in range(n) if i != missing][:r.d]
        contribs = {h: r.repair_contribution(h, missing, stacked[h])
                    for h in helpers}
        for pkg in BOTH:
            dec = impls[pkg].decode_batch(dict(sub), [missing])
            assert np.array_equal(dec[missing], stacked[missing]), (pkg, tech)
            rep = impls[pkg].repair(missing, dict(contribs))
            assert np.array_equal(rep, stacked[missing]), (pkg, tech)
    delta = _delta(MDEC, before, ("dispatches", "repair_solves",
                                  "col_folds", "fallbacks"))
    assert delta[PORT] == delta[JAX]
    assert delta[PORT]["dispatches"] >= 4
    assert delta[PORT]["repair_solves"] >= 2
    assert delta[PORT]["col_folds"] > 0


@pytest.mark.parametrize("site,kw,keep", [
    ("mesh.chip_fail", {"match": "chip=3/"}, (0, 1, 3, 4)),
    ("mesh.chip_slowdown", {"match": "chip=5/", "delay_us": 2_000_000},
     (1, 2, 3, 5))])
def test_rateless_decode_completes_from_subset_equal(clean, site, kw, keep):
    """A dead chip or a straggler (2 s: longer than any decode here, even
    on a loaded CPU) never blocks a rateless decode: the drain completes
    from the first spanning subset, byte-exact, with no fallback, in both
    packages."""
    _mesh_on(rateless=True)
    impls = _impls()
    rng = np.random.default_rng(41)
    fulls = [_encode_stacked(impls[PORT], rng, 8, 1024) for _ in range(2)]
    lost = [i for i in range(6) if i not in keep]
    before = {"rl": _snap(RL), "m": _snap(MDEC)}
    for pkg in BOTH:
        FAULTS[pkg].inject(site, mode="always", **kw)
        for full in fulls:
            got = impls[pkg].decode_batch({i: full[i] for i in keep}, lost)
            for i in lost:
                assert np.array_equal(got[i], full[i]), (pkg, i)
        FAULTS[pkg].clear(site)
    rl = _delta(RL, before["rl"], ("subset_completions", "host_resolves",
                                   "chip_failures"))
    m = _delta(MDEC, before["m"], ("fallbacks", "dispatches"))
    for pkg in BOTH:
        assert rl[pkg]["subset_completions"] > 0
        assert m[pkg]["fallbacks"] == 0
        if site == "mesh.chip_fail":
            assert rl[pkg]["host_resolves"] > 0
    assert rl[PORT]["chip_failures"] == rl[JAX]["chip_failures"]
    assert m[PORT]["dispatches"] == m[JAX]["dispatches"] == 2


def test_decode_site_raises_to_the_caller(clean):
    """By design: ``mesh.decode_batch`` raises out of ``decode_batch``
    (no single-device rerun, no journal event, no fallback count), where
    JAX's guard degrades byte-identically and journals the degrade."""
    _mesh_on()
    g_journal.reset()
    jax_journal.reset()
    impls = _impls()
    full = _encode_stacked(impls[PORT], np.random.default_rng(53), 4, 1024)
    before = _snap(MDEC)
    g_faults.inject("mesh.decode_batch", mode="always", error="device")
    with pytest.raises(InjectedDeviceError):
        impls[PORT].decode_batch({i: full[i] for i in (0, 2, 3, 4)}, [1])
    g_faults.clear("mesh.decode_batch")
    jax_faults.inject("mesh.decode_batch", mode="always", error="device")
    got = impls[JAX].decode_batch({i: full[i] for i in (0, 2, 3, 4)}, [1])
    jax_faults.clear("mesh.decode_batch")
    assert np.array_equal(got[1], full[1])
    delta = _delta(MDEC, before, ("fallbacks",))
    assert delta[PORT]["fallbacks"] == 0 and delta[JAX]["fallbacks"] > 0
    assert not [e for e in g_journal.merged()
                if e["type"] == "mesh_decode_degraded"]
    assert [e for e in jax_journal.merged()
            if e["type"] == "mesh_decode_degraded"]
    # the port's next decode, site cleared, rides the mesh again
    got = impls[PORT].decode_batch({i: full[i] for i in (0, 2, 3, 4)}, [1])
    assert np.array_equal(got[1], full[1])


def test_membership_mid_decode_drains_and_invalidates_equal(clean):
    """An ec_mesh_chips transition with decode groups queued: the old mesh
    drains them byte-exactly, the decode plans are invalidated and the
    next decode rebuilds on the 6-member mesh, in both packages."""
    _mesh_on()
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    set_both("ec_dispatch_batch_max", 64)
    impls = _impls()
    k, chunk = 4, 1024
    rng = np.random.default_rng(61)
    full = _encode_stacked(impls[PORT], rng, 4, chunk)
    queued = []
    for _ in range(3):
        fl = _encode_stacked(impls[PORT], rng, 2, chunk)
        queued.append(({i: np.asarray(fl[i]).reshape(-1)
                        for i in (0, 2, 3, 4, 5)},
                       np.ascontiguousarray(np.stack(
                           [fl[i] for i in range(k)], axis=1)).reshape(-1)))
    after_full = _encode_stacked(impls[PORT], rng, 4, chunk)
    before = {"member": _snap(MEMBER), "m": _snap(MDEC)}
    for pkg in BOTH:
        got = impls[pkg].decode_batch({i: full[i] for i in (0, 2, 3, 4)}, [1])
        assert np.array_equal(got[1], full[1])
        assert [p for p in MESH[pkg].dump()["plans"]
                if p.get("kind") == "decode"]
        si = ECUTIL[pkg].stripe_info_t(k, k * chunk)
        futs = [DISPATCHER[pkg].submit_decode_concat(si, impls[pkg],
                                                     dict(chunks))
                for chunks, _want in queued]
        CONF[pkg].set_checked("ec_mesh_chips", 6)
        assert MESH[pkg].topology().size == 6
        for f, (_c, want) in zip(futs, queued):
            assert np.asarray(f.result()).tobytes() == want.tobytes()
        assert not [p for p in MESH[pkg].dump()["plans"]
                    if p.get("kind") == "decode"]
        got = impls[pkg].decode_batch(
            {i: after_full[i] for i in (0, 2, 3, 4)}, [1])
        assert np.array_equal(got[1], after_full[1])
    mem = _delta(MEMBER, before["member"], ("drained_reqs", "transitions",
                                            "chip_retires"))
    assert mem[PORT] == mem[JAX]
    assert mem[PORT]["drained_reqs"] >= 3
    # plan builds are not compared: the JAX dispatcher pads the queued
    # groups' 6 stripes to 8 on its device route (backend=tpu) and the
    # port's does not for backend=host, so only JAX's flush misses the
    # byte-folded plan of the first decode (the port pads on the card)
    m = _delta(MDEC, before["m"], ("plan_builds", "fallbacks"))
    for pkg in BOTH:
        assert m[pkg]["plan_builds"] >= 2 and m[pkg]["fallbacks"] == 0


def _shard_bodies(c):
    out = {}
    for i, osd in c.osds.items():
        for cid in osd.store.list_collections():
            if "_meta" in cid or "s" not in cid.split(".")[-1]:
                continue
            for ho in osd.store.list_objects(cid):
                out[(i, cid, str(ho))] = bytes(osd.store.read(cid, ho))
    return out


def _degraded_life(pkg, mesh: bool):
    conf = CONF[pkg]
    for name in ("ec_mesh_chips", "ec_mesh_rateless",
                 "ec_dispatch_batch_window_us"):
        conf.rm_val(name)
    if mesh:
        conf.set_val("ec_mesh_chips", 8)
        conf.set_val("ec_mesh_rateless", True)
        conf.set_val("ec_dispatch_batch_window_us", 200_000)
    MESH[pkg].topology()
    c = CLUSTER[pkg](n_osds=6)
    c.create_ec_pool("dtwin", k=3, m=2, pg_num=4, **POOL[pkg])
    cl = c.client("client.dtwin")
    rng = np.random.default_rng(77)
    expected = {}
    for i in range(3):
        body = bytes(rng.integers(0, 256, 9000 + 3001 * i, dtype=np.uint8))
        assert cl.write_full("dtwin", f"o{i}", body) == 0
        expected[f"o{i}"] = body
    pid = c.mon.osdmap.lookup_pg_pool_name("dtwin")
    victim = next(
        o.osd_id for o in c.osds.values()
        for cid in o.store.list_collections()
        if cid.startswith(f"{pid}.") and "s" in cid
        and cid.rsplit("s", 1)[1] in ("1", "2")
        and any(ho.oid == "o0" for ho in o.store.list_objects(cid)))
    c.kill_osd(victim)
    c.mark_osd_down(victim)
    for oid, body in expected.items():
        assert cl.read("dtwin", oid) == body, (pkg, mesh, oid)
    return victim, _shard_bodies(c)


def test_twin_cluster_degraded_reads_equal(clean):
    """Degraded reads through the meshed rateless decode: every read
    byte-exact, stored bodies equal to the single-device port cluster and
    to the meshed JAX cluster, the same victim in all three."""
    before = _snap(MDEC)
    vp, meshed = _degraded_life(PORT, mesh=True)
    vj, jmeshed = _degraded_life(JAX, mesh=True)
    delta = _delta(MDEC, before, ("dispatches", "fallbacks"))
    assert delta[PORT]["dispatches"] > 0 and delta[JAX]["dispatches"] > 0
    assert delta[PORT]["fallbacks"] == 0
    vs, single = _degraded_life(PORT, mesh=False)
    assert vp == vj == vs
    assert meshed == single == jmeshed
