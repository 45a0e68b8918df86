"""The port's composed-chaos engine against the JAX package's, on the CPU.

Composing is host code: the same seed (and leg set) gives equal specs in
both packages, the engine compiles a spec into equal traffic shapes, and
the ``chaos compose`` / ``chaos dump`` admin-socket panes agree.  Running
a storyline needs the 8-chip mesh (``BASE_MESH_CHIPS``), so the port's
``run_scenario`` raises ``NotImplementedError`` at its mesh switch and
restores every option it set (ROADMAP Queue 3).
"""
import pytest

from ceph_tpu.chaos import compose_scenario as jax_compose
from ceph_tpu.chaos import engine as jax_engine
from ceph_tpu.chaos import leg_names as jax_legs
from ceph_tpu.cluster import MiniCluster as JaxCluster

from ceph_tpu_torch.chaos import (BASE_MESH_CHIPS, compose_scenario,
                                  leg_names, run_scenario, run_seed)
from ceph_tpu_torch.chaos import engine as port_engine
from ceph_tpu_torch.chaos.engine import TOUCHED, chaos_perf_counters
from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.common.config import g_conf

from torch_daemon_twin import clean  # noqa: F401


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


def test_run_scenario_raises_until_the_mesh(clean):
    """Queue 3, by design: the storyline's 8-chip mesh is not ported."""
    g_conf.set_val("ec_dispatch_batch_max", 7)
    before = {n: g_conf.values.get(n) for n in TOUCHED}
    pc = chaos_perf_counters()
    n0 = pc.dump()["scenarios"]
    with pytest.raises(NotImplementedError, match="mesh"):
        run_scenario(compose_scenario(1616))
    with pytest.raises(NotImplementedError, match="mesh"):
        run_seed(3, legs=("recovery_storm",))
    assert {n: g_conf.values.get(n) for n in TOUCHED} == before
    dump = pc.dump()
    assert dump["scenarios"] == n0 and dump["active"] == 0
