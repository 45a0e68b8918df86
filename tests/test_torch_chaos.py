"""The port's composed-chaos engine against the JAX package's, on the CPU.

Composing is host code: the same seed (and leg set) gives equal specs in
both packages, the engine compiles a spec into equal traffic shapes, and
the ``chaos compose`` / ``chaos dump`` admin-socket panes agree.  Running
a storyline: the pinned seeds 24 and 103 and the two forced-leg storylines
of ``test_chaos_composer.py`` run on both packages (JAX on its 8 virtual
devices, the port on 8 CPU members with ``device="cpu"``, torch on one
thread).  The receipts hold equal invariants: legs, acceptance,
byte-exactness, wedges, the expected checks raised, cleared and bundled,
every raise resolved, the storyline told, ops completed, zero mesh
fallbacks; storylines without a straggler leg also equal harness rounds.
The scoreboard probes every flush on the wall clock (a straggler leg's
30 ms delay, or a collateral raise when the host stalls), so settle
ticks, journal events and incident bundles are held to the settle budget
and to every bundle resolved in each package, not compared.  Every
option the engine sets is restored.
The ``device_error`` leg's site is checked by the JAX fault guard and by
nothing in the port (ROADMAP Queue 3).
"""
import numpy as np
import pytest

from ceph_tpu.chaos import compose_scenario as jax_compose
from ceph_tpu.chaos import engine as jax_engine
from ceph_tpu.chaos import leg_names as jax_legs
from ceph_tpu.chaos import run_scenario as jax_run_scenario
from ceph_tpu.cluster import MiniCluster as JaxCluster

from ceph_tpu_torch.chaos import (BASE_MESH_CHIPS, compose_scenario,
                                  leg_names, run_scenario, run_seed)
from ceph_tpu_torch.chaos import engine as port_engine
from ceph_tpu_torch.chaos.engine import TOUCHED, chaos_perf_counters
from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.common.config import g_conf

from torch_daemon_twin import clean, one_thread, reset_both  # noqa: F401


def test_leg_catalog_equal():
    assert leg_names() == jax_legs()
    assert BASE_MESH_CHIPS == 8


@pytest.mark.parametrize("seed", [0, 1, 7, 1616, 20260807, 987654321])
def test_compose_scenario_equal_specs(seed):
    assert compose_scenario(seed).dump() == jax_compose(seed).dump()


@pytest.mark.parametrize("legs", [
    ("recovery_storm",), ("abusive_client", "msg_drop"),
    ("chip_straggler", "control_flap"), ("mesh_membership",),
    ("shard_eio", "device_error", "capture_drop")])
def test_compose_scenario_equal_for_a_leg_set(legs):
    for seed in (3, 44):
        p, j = compose_scenario(seed, legs=legs), jax_compose(seed, legs=legs)
        assert p.dump() == j.dump()
        assert p.legs == legs


def test_compose_refuses_what_jax_refuses():
    with pytest.raises(ValueError) as pe:
        compose_scenario(1, legs=("no_such_leg",))
    with pytest.raises(ValueError) as je:
        jax_compose(1, legs=("no_such_leg",))
    assert str(pe.value) == str(je.value)
    # an empty leg set is no refusal: both sample the same storyline
    assert compose_scenario(1, legs=()).dump() == \
        jax_compose(1, legs=()).dump()


@pytest.mark.parametrize("seed", [5, 1616])
def test_compile_gives_equal_traffic(seed):
    """The engine's declarative schedule -> TrafficSpec: equal events and
    shape; the hooks fire at the same rounds."""
    p = port_engine._compile(compose_scenario(seed), "chaos", 6, 12, 3.0)
    j = jax_engine._compile(jax_compose(seed), "chaos", 6, 12, 3.0)
    assert p.events == j.events
    assert [r for r, _fn in p.hooks] == [r for r, _fn in j.hooks]
    for key in ("pool", "n_clients", "ops_per_client", "read_fraction",
                "keys_per_client", "mode", "rate", "rate_multipliers",
                "seed", "tick_every"):
        assert getattr(p, key) == getattr(j, key), key


def test_asok_panes_equal(clean):
    p, j = PortCluster(n_osds=3), JaxCluster(n_osds=3)
    args = {"seed": "1616", "legs": "recovery_storm,msg_drop"}
    assert p.admin_socket.execute("chaos compose", args) == \
        j.admin_socket.execute("chaos compose", args)
    pd, jd = p.admin_socket.execute("chaos dump"), \
        j.admin_socket.execute("chaos dump")
    assert pd["legs"] == jd["legs"]
    assert pd["fault_sites"] == jd["fault_sites"]
    assert pd["options"] == jd["options"]
    assert pd["counters"].keys() == jd["counters"].keys()


# the invariants of a receipt; the rest (settle ticks, journal events,
# incident bundles) follows the wall-clock scoreboard too
INVARIANTS = ("seed", "legs", "accepted", "byte_exact", "wedged", "checks",
              "all_raises_resolved", "storyline_told", "ops_completed",
              "mesh_fallbacks")
WALL_LEGS = {"chip_straggler", "degraded_read_straggler"}
STORYLINES = {
    "seed24": (24, None),
    "seed103": (103, None),
    "storm_straggler_abusive": (20260807, ("abusive_client",
                                           "chip_straggler",
                                           "recovery_storm")),
    "degraded_read_under_straggler": (28, ("chip_fail",
                                           "degraded_read_straggler",
                                           "shard_eio")),
}


@pytest.fixture
def members(one_thread):
    """8 CPU mesh members; the count before is restored after (other test
    files of the worker set theirs when they are imported)."""
    from ceph_tpu_torch.mesh import (members_per_device,
                                     set_members_per_device)
    before = members_per_device()
    set_members_per_device(8)
    yield
    set_members_per_device(before)


@pytest.mark.parametrize("name", sorted(STORYLINES))
def test_storyline_receipts_equal(name, clean, members):
    seed, legs = STORYLINES[name]
    g_conf.set_val("ec_dispatch_batch_max", 7)
    before = {n: g_conf.values.get(n) for n in TOUCHED}
    pc = chaos_perf_counters()
    n0 = pc.dump()["scenarios"]
    spec = compose_scenario(seed, legs=legs)
    assert spec.dump() == jax_compose(seed, legs=legs).dump()
    j = jax_run_scenario(jax_compose(seed, legs=legs))
    reset_both()
    g_conf.set_val("ec_dispatch_batch_max", 7)
    p = run_scenario(spec, device="cpu")
    assert {n: g_conf.values.get(n) for n in TOUCHED} == before
    assert pc.dump()["scenarios"] == n0 + 1
    assert pc.dump()["active"] == 0
    assert p.keys() == j.keys()
    for key in INVARIANTS:
        assert p[key] == j[key], key
    assert p["accepted"] and p["byte_exact"] and not p["wedged"]
    assert p["mesh_fallbacks"] == 0
    if not WALL_LEGS & set(spec.legs):
        assert p["rounds"] == j["rounds"]
    budget = int(g_conf.get_val("chaos_settle_ticks_max"))
    for r in (p, j):
        assert 0 < r["settle_ticks"] <= budget
        assert r["journal_events"] > 0
        assert all(b["state"] == "resolved"
                   for b in r["incidents"]["bundles"])


def test_run_seed_composes_and_runs(clean, members):
    """``run_seed`` is ``run_scenario(compose_scenario(seed, legs))``."""
    r = run_seed(3, legs=("recovery_storm",), device="cpu")
    reset_both()
    again = run_scenario(compose_scenario(3, legs=("recovery_storm",)),
                         device="cpu")
    assert r == again and r["legs"] == ["recovery_storm"]
    assert r["accepted"]


def test_device_error_site_is_silent_in_the_port(clean):
    """Queue 3, by design: the ``device_error`` leg arms
    ``device.encode_batch``.  The JAX plugin checks that site inside its
    fault guard (its retries and host fallback absorb the injected
    errors); the port has no guard, so no code checks it and the armed
    fault never fires.  The coding is equal either way."""
    from ceph_tpu.ec.tpu_plugin import ErasureCodeTpu
    from ceph_tpu.fault import g_faults as jax_faults
    from ceph_tpu_torch.ec.cuda_plugin import ErasureCodeCuda
    from ceph_tpu_torch.fault import g_faults
    prof = {"k": "4", "m": "2", "technique": "reed_sol_van"}
    jimpl, pimpl = ErasureCodeTpu(), ErasureCodeCuda()
    jimpl.init(dict(prof))
    pimpl.init({**prof, "backend": "host"})
    data = np.random.default_rng(7).integers(0, 256, (3, 4, 1024),
                                             dtype=np.uint8)
    for faults in (g_faults, jax_faults):
        faults.inject("device.encode_batch", mode="nth", n=1)
    j, p = jimpl.encode_batch(data), pimpl.encode_batch(data)
    np.testing.assert_array_equal(p, j)
    jspec = jax_faults.armed("device.encode_batch")
    pspec = g_faults.armed("device.encode_batch")
    assert jspec.checks >= 1 and jspec.fires >= 1
    assert pspec.checks == 0 and pspec.fires == 0
