"""The port's rateless coder and skew scoreboard on the mesh against the
JAX package's, on the CPU.

JAX side: ``ceph_tpu.mesh`` on the 8 virtual CPU devices of
``tests/conftest.py`` with ``backend=tpu`` codecs; port side: 8 CPU
members (``set_members_per_device(8)``) with ``backend=host`` codecs.
The cases are ``tests/test_mesh_rateless.py``'s and
``tests/test_mesh_skew.py``'s: rateless off by default, byte identity of
rateless-coded groups with probes on every flush, a dead chip
(``mesh.chip_fail``) completed from the surviving subset, a SUSPECT chip
deweighted to parity only under ``mesh.chip_slowdown``, the task knob and
dump pane, the wasted-block price, the rateless family on Prometheus,
the probe cadence, the OSD tick's cadence floor, the scoreboard naming
exactly the slowed chip (raise and clear of ``TPU_MESH_SKEW``) and the
single slow probe that never suspects.  Outputs are byte-equal between
the packages and to the oracle; deterministic counter deltas (flushes,
coded and parity tasks, chip failures, probes, samples) are equal.

By design: when the surviving blocks cannot span, the port's flush
raises ``Insufficient`` to the dispatcher (which re-runs each request
alone) and the mesh's ``fallbacks`` stays 0; JAX's guard degrades and
counts.
"""
import time

import numpy as np
import pytest

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.dispatch import g_dispatcher as jax_dispatcher
from ceph_tpu.ec.isa import ErasureCodeIsa as JaxIsa
from ceph_tpu.ec.tpu_plugin import ErasureCodeTpu as JaxTpu
from ceph_tpu.fault import g_faults as jax_faults
from ceph_tpu.mesh import g_chipstat as jax_chipstat
from ceph_tpu.mesh import g_mesh as jax_mesh
from ceph_tpu.mesh import mesh_chip_perf_counters as jax_chip_pc
from ceph_tpu.mesh import mesh_perf_counters as jax_mesh_pc
from ceph_tpu.mesh import rateless_perf_counters as jax_rl_pc
from ceph_tpu.osd import ecutil as jax_ecutil

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.dispatch import g_dispatcher
from ceph_tpu_torch.ec.cuda_plugin import ErasureCodeCuda
from ceph_tpu_torch.ec.isa import ErasureCodeIsa
from ceph_tpu_torch.fault import g_faults
from ceph_tpu_torch.mesh import (g_chipstat, g_mesh, mesh_chip_perf_counters,
                                 mesh_perf_counters, rateless_perf_counters,
                                 set_members_per_device)
from ceph_tpu_torch.mesh.chipstat import SKEW_SUSTAIN_PROBES
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.trace import g_perf_histograms

from torch_daemon_twin import JAX, PORT, clean, set_both  # noqa: F401

set_members_per_device(8)

DISPATCHER = {PORT: g_dispatcher, JAX: jax_dispatcher}
ECUTIL = {PORT: ecutil, JAX: jax_ecutil}
MESH = {PORT: g_mesh, JAX: jax_mesh}
CHIPSTAT = {PORT: g_chipstat, JAX: jax_chipstat}
FAULTS = {PORT: g_faults, JAX: jax_faults}
RL = {PORT: rateless_perf_counters, JAX: jax_rl_pc}
MPC = {PORT: mesh_perf_counters, JAX: jax_mesh_pc}
CHIP = {PORT: mesh_chip_perf_counters, JAX: jax_chip_pc}
CLUSTER = {PORT: PortCluster, JAX: JaxCluster}
POOL = {JAX: {"plugin": "tpu"},
        PORT: {"plugin": "cuda", "extra_profile": {"backend": "host"}}}
BOTH = (PORT, JAX)


def _rateless_on(chips=8, sample_every=0, tasks=0, rateless=True):
    set_both("ec_mesh_chips", chips)
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    set_both("ec_dispatch_batch_max", 64)
    set_both("ec_mesh_skew_sample_every", sample_every)
    if rateless:
        set_both("ec_mesh_rateless", True)
    if tasks:
        set_both("ec_mesh_rateless_tasks", tasks)


def _impls(kind="cuda", k=4, m=2, technique="reed_sol_van"):
    prof = {"k": str(k), "m": str(m), "technique": technique}
    port = {"cuda": ErasureCodeCuda, "isa": ErasureCodeIsa}[kind]()
    port.init({**prof, "backend": "host"})
    ref = {"cuda": JaxTpu, "isa": JaxIsa}[kind]()
    ref.init({**prof, "backend": "tpu"})
    return {PORT: port, JAX: ref}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for i in a:
        assert np.asarray(a[i]).tobytes() == np.asarray(b[i]).tobytes(), i


def _flush(pkg, impls, payloads, k=4, chunk=1024):
    """One coalesced flush of *payloads* through *pkg*'s dispatcher,
    byte-checked against the port's single-device oracle."""
    want = set(range(impls[PORT].k + impls[PORT].m))
    si = ECUTIL[pkg].stripe_info_t(k, k * chunk)
    futs = [DISPATCHER[pkg].submit_encode(si, impls[pkg], p, want)
            for p in payloads]
    DISPATCHER[pkg].flush()
    for f, p in zip(futs, payloads):
        _same(f.result(), ecutil.encode(ecutil.stripe_info_t(k, k * chunk),
                                        impls[PORT], p, want))


def _payloads(rng, n=3, stripes=2, k=4, chunk=1024):
    return [rng.integers(0, 256, size=stripes * k * chunk, dtype=np.uint8)
            for _ in range(n)]


def _delta(fam, before, names):
    return {pkg: {n: fam[pkg]().dump()[n] - before[pkg][n] for n in names}
            for pkg in BOTH}


def _snap(fam):
    return {pkg: dict(fam[pkg]().dump()) for pkg in BOTH}


def test_rateless_off_by_default_equal(clean):
    assert bool(g_conf.get_val("ec_mesh_rateless")) is False
    _rateless_on(rateless=False)
    before = _snap(RL)
    impls = _impls()
    d = [(np.arange(2 * 4 * 1024) % 251).astype(np.uint8)]
    for pkg in BOTH:
        _flush(pkg, impls, d)
    delta = _delta(RL, before, ("flushes",))
    assert delta[PORT] == delta[JAX] == {"flushes": 0}
    pane, jpane = g_mesh.dump()["rateless"], jax_mesh.dump()["rateless"]
    assert pane["options"] == jpane["options"]
    assert pane["counters"].keys() == jpane["counters"].keys()


MIX = [("cuda", 4, 2, "reed_sol_van"), ("cuda", 8, 4, "reed_sol_van"),
       ("isa", 3, 2, "cauchy"), ("isa", 6, 3, "reed_sol_van")]


@pytest.mark.parametrize("seed", [7, 31])
def test_rateless_byte_identity_equal(clean, seed):
    _rateless_on(sample_every=1)
    rng = np.random.default_rng(seed)
    pairs = [_impls(*spec) for spec in MIX]
    specs = []
    for _ in range(12):
        pair = pairs[rng.integers(0, len(pairs))]
        k, m = pair[PORT].k, pair[PORT].m
        chunk = int(rng.choice([512, 768, 1024, 1536]))
        stripes = int(rng.integers(1, 7))
        specs.append((pair, k, m, chunk, rng.integers(
            0, 256, size=stripes * k * chunk, dtype=np.uint8)))
    before = _snap(RL)
    for pkg in BOTH:
        futs = [DISPATCHER[pkg].submit_encode(
            ECUTIL[pkg].stripe_info_t(k, k * chunk), pair[pkg], data,
            set(range(k + m))) for pair, k, m, chunk, data in specs]
        DISPATCHER[pkg].flush()
        for (pair, k, m, chunk, data), f in zip(specs, futs):
            _same(f.result(), ecutil.encode(
                ecutil.stripe_info_t(k, k * chunk), pair[PORT], data,
                set(range(k + m))))
    delta = _delta(RL, before, ("flushes", "coded_tasks", "parity_tasks"))
    assert delta[PORT] == delta[JAX]
    assert delta[PORT]["flushes"] > 0
    assert g_chipstat.summary()["probes"] > 0


def test_chip_fail_completes_from_surviving_subset_equal(clean):
    """One chip dead mid-flush is an erasure: every op completes from the
    surviving subset with host re-solves and no mesh fallback."""
    _rateless_on()
    impls = _impls()
    rng = np.random.default_rng(3)
    loads = [_payloads(rng) for _ in range(3)]
    for pkg in BOTH:
        _flush(pkg, impls, loads[0])             # warmup, healthy
    before = {fam: _snap(f) for fam, f in (("rl", RL), ("m", MPC))}
    for pkg in BOTH:
        FAULTS[pkg].inject("mesh.chip_fail", mode="always", match="chip=3/")
        for p in loads[1:]:
            _flush(pkg, impls, p)
        FAULTS[pkg].clear("mesh.chip_fail")
    rl = _delta(RL, before["rl"], ("chip_failures", "host_resolves",
                                   "subset_completions", "flushes"))
    m = _delta(MPC, before["m"], ("fallbacks", "dispatches"))
    for pkg in BOTH:
        assert rl[pkg]["host_resolves"] > 0
        assert rl[pkg]["subset_completions"] > 0
        assert m[pkg]["fallbacks"] == 0
    assert rl[PORT]["chip_failures"] == rl[JAX]["chip_failures"] >= 2
    assert rl[PORT]["flushes"] == rl[JAX]["flushes"] == 2


def test_insufficient_survivors_raise_to_the_dispatcher(clean):
    """By design: with every chip failed the port's flush raises
    ``Insufficient``; the dispatcher re-runs each request alone
    (byte-identical) and the mesh's ``fallbacks`` stays 0, where JAX's
    guard degrades and counts a fallback."""
    _rateless_on()
    impls = _impls()
    loads = _payloads(np.random.default_rng(5))
    before = {fam: _snap(f) for fam, f in (("rl", RL), ("m", MPC))}
    for pkg in BOTH:
        FAULTS[pkg].inject("mesh.chip_fail", mode="always")
        _flush(pkg, impls, loads)
        FAULTS[pkg].clear()
    rl = _delta(RL, before["rl"], ("insufficient",))
    m = _delta(MPC, before["m"], ("fallbacks",))
    assert rl[PORT]["insufficient"] > 0 and rl[JAX]["insufficient"] > 0
    assert m[PORT]["fallbacks"] == 0
    assert m[JAX]["fallbacks"] > 0


@pytest.mark.parametrize("pkg", BOTH)
def test_suspect_chip_deweighted_to_parity_only(clean, pkg):
    """Once chip 5 is SUSPECT its placement carries zero real stripes and
    the flush no longer waits for it, still 10 s slow: the flush itself
    (its oracle encodes outside the clock) ends far inside that, even on
    a CPU that other test workers share."""
    _rateless_on(sample_every=1)
    set_both("ec_mesh_skew_threshold", 3.0)
    impls = _impls()
    rng = np.random.default_rng(11)
    _flush(pkg, impls, _payloads(rng))           # warmup
    CHIPSTAT[pkg].reset()
    dw0 = RL[pkg]().dump()["suspect_deweights"]
    FAULTS[pkg].inject("mesh.chip_slowdown", mode="always",
                       match="chip=5/", delay_us=10_000_000)
    try:
        for _ in range(8):
            _flush(pkg, impls, _payloads(rng))
            if CHIPSTAT[pkg].suspects():
                break
        assert [s["chip"] for s in CHIPSTAT[pkg].suspects()] == [5]
        before = {i: v["stripes"] for i, v in MESH[pkg].per_chip().items()}
        loads = _payloads(rng)
        si = ECUTIL[pkg].stripe_info_t(4, 4 * 1024)
        t0 = time.perf_counter()
        futs = [DISPATCHER[pkg].submit_encode(si, impls[pkg], p,
                                              set(range(6))) for p in loads]
        DISPATCHER[pkg].flush()
        results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        after = {i: v["stripes"] for i, v in MESH[pkg].per_chip().items()}
    finally:
        FAULTS[pkg].clear("mesh.chip_slowdown")
    for res, p in zip(results, loads):
        _same(res, ecutil.encode(ecutil.stripe_info_t(4, 4 * 1024),
                                 impls[PORT], p, set(range(6))))
    assert after[5] == before.get(5, 0)
    assert sum(after.values()) > sum(before.values())
    assert RL[pkg]().dump()["suspect_deweights"] > dw0
    assert wall < 5.0, wall


def test_task_knob_and_dump_pane_equal(clean):
    _rateless_on(tasks=12)
    impls = _impls()
    d = [(np.arange(2 * 4 * 1024) % 251).astype(np.uint8)]
    for pkg in BOTH:
        _flush(pkg, impls, d)
    panes = {pkg: DISPATCHER[pkg].dump()["mesh"]["rateless"]
             for pkg in BOTH}
    for pane in panes.values():
        assert pane["options"] == {"ec_mesh_rateless": True,
                                   "ec_mesh_rateless_tasks": 12}
        assert pane["n_sys"] == 8 and pane["n_parity"] == 4
    assert panes[PORT].keys() == panes[JAX].keys()
    assert panes[PORT]["counters"].keys() == panes[JAX]["counters"].keys()
    set_both("ec_mesh_rateless_tasks", 3)
    for pkg in BOTH:
        _flush(pkg, impls, d)
        assert DISPATCHER[pkg].dump()["mesh"]["rateless"]["n_parity"] == 1


def test_wasted_blocks_price_equal(clean):
    """A healthy flush launches 8 systematic + 2 parity blocks and
    wastes at most the parity; nothing is re-solved."""
    _rateless_on()
    impls = _impls()
    d = [(np.arange(2 * 4 * 1024) % 251).astype(np.uint8)]
    for pkg in BOTH:
        _flush(pkg, impls, d)                    # warmup
    before = _snap(RL)
    for pkg in BOTH:
        _flush(pkg, impls, d)
    delta = _delta(RL, before, ("coded_tasks", "wasted_blocks",
                                "host_resolves"))
    for pkg in BOTH:
        assert delta[pkg]["coded_tasks"] == 10
        assert 0 < delta[pkg]["wasted_blocks"] <= 2
        assert delta[pkg]["host_resolves"] == 0


def _shard_bodies(c):
    out = {}
    for i, osd in c.osds.items():
        for cid in osd.store.list_collections():
            if "_meta" in cid or "s" not in cid.split(".")[-1]:
                continue
            for ho in osd.store.list_objects(cid):
                out[(i, cid, str(ho))] = bytes(osd.store.read(cid, ho))
    return out


def test_rateless_cluster_twin_and_prometheus_equal(clean):
    """A rateless cluster stores shard bodies byte-equal to the JAX one,
    and the mesh_rateless family renders on Prometheus."""
    _rateless_on()
    set_both("ec_dispatch_batch_window_us", 200_000)
    bodies, proms = {}, {}
    for pkg in BOTH:
        MESH[pkg].topology()
        c = CLUSTER[pkg](n_osds=6)
        c.create_ec_pool("rl", k=3, m=2, pg_num=4, **POOL[pkg])
        cl = c.client("client.rl")
        rng = np.random.default_rng(55)
        for i in range(3):
            body = bytes(rng.integers(0, 256, 9000 + 4111 * i,
                                      dtype=np.uint8))
            assert cl.write_full("rl", f"o{i}", body) == 0
            assert cl.read("rl", f"o{i}") == body
        bodies[pkg] = _shard_bodies(c)
        proms[pkg] = c.admin_socket.execute("prometheus metrics")
    assert bodies[PORT] == bodies[JAX]
    for cname in ("flushes", "coded_tasks", "parity_tasks",
                  "wasted_blocks", "subset_completions", "host_resolves",
                  "suspect_deweights"):
        assert any(ln.startswith(f"ceph_daemon_mesh_rateless_{cname} ")
                   for ln in proms[PORT].splitlines()), cname
    flushes = next(float(ln.split()[-1]) for ln in proms[PORT].splitlines()
                   if ln.startswith("ceph_daemon_mesh_rateless_flushes "))
    assert flushes > 0


# ---- the skew scoreboard (tests/test_mesh_skew.py's cases) ---------------

def test_probe_cadence_every_nth_flush_equal(clean):
    _rateless_on(rateless=False)
    impls = _impls()
    rng = np.random.default_rng(20260804)
    loads = [_payloads(rng) for _ in range(6)]
    for pkg in BOTH:
        CHIPSTAT[pkg].reset()
        for p in loads[:3]:
            _flush(pkg, impls, p)
        assert CHIPSTAT[pkg].summary()["probes"] == 0
    set_both("ec_mesh_skew_sample_every", 2)
    for pkg in BOTH:
        CHIPSTAT[pkg].reset()
        for p in loads:
            _flush(pkg, impls, p)
        pc = CHIP[pkg]().dump()
        assert pc["probes"] == 3 and pc["samples"] == 3 * 8
        per_chip = CHIPSTAT[pkg].summary()["per_chip"]
        assert len(per_chip) == 8
        assert all(row["probes"] == 3 for row in per_chip.values())
    hist = g_perf_histograms.get("mesh", "mesh_chip_latency_histogram")
    assert hist.total_count == 3 * 8
    assert [a.name for a in hist.axes] == ["probe_usec", "chip_index"]


def test_osd_tick_arms_probe_cadence_floor_equal(clean):
    _rateless_on(rateless=False, sample_every=1000)
    impls = _impls()
    rng = np.random.default_rng(9)
    for pkg in BOTH:
        c = CLUSTER[pkg](n_osds=4)
        CHIPSTAT[pkg].reset()
        _flush(pkg, impls, _payloads(rng))
        assert CHIPSTAT[pkg].summary()["probes"] == 0
        c.tick(dt=1.0)
        _flush(pkg, impls, _payloads(rng))
        assert CHIPSTAT[pkg].summary()["probes"] == 1
        c.tick(dt=1.0)
        _flush(pkg, impls, _payloads(rng))
        _flush(pkg, impls, _payloads(rng))
        assert CHIPSTAT[pkg].summary()["probes"] == 1


def test_scoreboard_marks_exactly_the_slowed_chip_equal(clean):
    """Chip 5 slowed 200 ms (far above a member's service time, even on a
    loaded CPU): both scoreboards suspect exactly chip 5 after the
    sustain window, TPU_MESH_SKEW raises on the ticked mgr, and clears
    after the fault is removed; outputs stay byte-identical."""
    _rateless_on(rateless=False, sample_every=1)
    set_both("ec_mesh_skew_threshold", 3.0)
    impls = _impls()
    rng = np.random.default_rng(20260804)
    for pkg in BOTH:
        c = CLUSTER[pkg](n_osds=4)
        _flush(pkg, impls, _payloads(rng))       # warmup
        CHIPSTAT[pkg].reset()
        for _ in range(4):
            _flush(pkg, impls, _payloads(rng))
            c.tick(dt=1.0)
        assert CHIPSTAT[pkg].suspects() == []
        assert "TPU_MESH_SKEW" not in c.mgr.health_checks
        FAULTS[pkg].inject("mesh.chip_slowdown", mode="always",
                           match="chip=5/", delay_us=200_000)
        detection = 0
        for i in range(1, 9):
            _flush(pkg, impls, _payloads(rng))
            c.tick(dt=1.0)
            if CHIPSTAT[pkg].suspects():
                detection = i
                break
        suspects = CHIPSTAT[pkg].suspects()
        assert [s["chip"] for s in suspects] == [5], (pkg, suspects)
        assert suspects[0]["skew_ratio"] >= 3.0
        assert detection == SKEW_SUSTAIN_PROBES
        msg = c.mgr.health_checks.get("TPU_MESH_SKEW", "")
        assert "chip 5" in msg, msg
        d = c.admin_socket.execute("dispatch dump")["mesh"]["skew"]
        assert d["suspects"][0]["chip"] == 5
        FAULTS[pkg].clear("mesh.chip_slowdown")
        for _ in range(24):
            _flush(pkg, impls, _payloads(rng))
            c.tick(dt=1.0)
            if not CHIPSTAT[pkg].suspects() \
                    and "TPU_MESH_SKEW" not in c.mgr.health_checks:
                break
        assert CHIPSTAT[pkg].suspects() == []
        assert "TPU_MESH_SKEW" not in c.mgr.health_checks


def test_single_slow_probe_never_suspects_equal(clean):
    _rateless_on(rateless=False, sample_every=1)
    set_both("ec_mesh_skew_threshold", 3.0)
    impls = _impls()
    rng = np.random.default_rng(17)
    for pkg in BOTH:
        _flush(pkg, impls, _payloads(rng))
        CHIPSTAT[pkg].reset()
        for _ in range(3):
            _flush(pkg, impls, _payloads(rng))
        FAULTS[pkg].inject("mesh.chip_slowdown", mode="always",
                           match="chip=2/", delay_us=200_000, count=1)
        for _ in range(SKEW_SUSTAIN_PROBES + 2):
            _flush(pkg, impls, _payloads(rng))
        assert CHIPSTAT[pkg].suspects() == []
    assert g_chipstat.dump().keys() == jax_chipstat.dump().keys()
