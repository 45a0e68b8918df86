"""The bench's harnesses on top of the mesh against the JAX package's, on
the CPU: ``measure_slo_autotune`` (the controller's three closed-loop
scenarios and the disabled twin) at its defaults (seed 20260807) and
``measure_composed_chaos(seeds=(24,))``, the CLI's smoke shapes.

JAX runs on its 8 virtual devices, the port on 8 CPU members with
``device="cpu"``, torch on one thread (``backend=host`` codecs: the recovery leg's
``regenerating`` pool and the straggler leg's codec, which the JAX
package names ``ErasureCodeTpu``).  The receipts that judge the run are
equal: the ``control`` block (each scenario raised, moved, cleared, in
bounds, with its convergence ticks; the disabled twin's moves), the
incident receipts and ledger entries, the metric's value, and the
``chaos`` block.  The straggler scenario detects a 30 ms injected delay
on the wall clock, so its tick counts, moves and widths (and the value,
the worst convergence) are held to the JAX budget (``tick_budget``) in
each package and compared only in what they decide: raised, cleared and
in bounds.  ``devflow`` and
``stage_breakdown`` carry wall times and each package's own transfers,
and are compared by their keys.  Both packages' regress.py CONTROL and
CHAOS gates pass each line.
"""
import pytest

from ceph_tpu.bench import workloads as jw
from ceph_tpu.bench.regress import _chaos_gate as jax_chaos_gate
from ceph_tpu.bench.regress import _control_gate as jax_control_gate

from ceph_tpu_torch.bench import workloads as pw
from ceph_tpu_torch.bench.regress import _chaos_gate, _control_gate
from ceph_tpu_torch.bench.schema import validate_metric

from torch_daemon_twin import clean, one_thread, reset_both  # noqa: F401

TIMED = ("devflow", "stage_breakdown", "wall_s", "launches")


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


def _tick_clock(m):
    """The autotune line without what the straggler scenario reads off
    the wall clock."""
    out = {k: v for k, v in m.items()
           if k not in TIMED + ("value", "stats", "receipts", "incidents")}
    ctrl = dict(out.pop("control"))
    scen = dict(ctrl.pop("scenarios"))
    strag = scen.pop("straggler")
    out["control"] = {**ctrl, "scenarios": scen,
                      "straggler": {k: strag[k] for k in
                                    ("raised", "cleared", "in_bounds")}}
    out["incidents"] = {leg: v for leg, v in m["incidents"].items()
                        if leg != "straggler"}
    out["receipts"] = [e for e in m["receipts"]
                       if e["knob"] != "ec_mesh_rateless_tasks"]
    return out


def test_measure_slo_autotune_equal(clean, members):
    j = jw.measure_slo_autotune()
    reset_both()
    p = pw.measure_slo_autotune(device="cpu")
    validate_metric(p)
    assert p.keys() == set(j) | {"launches"}
    for key in ("devflow", "stage_breakdown"):
        assert p[key].keys() == j[key].keys()
    assert _tick_clock(p) == _tick_clock(j)
    assert p["incidents"].keys() == j["incidents"].keys()
    ctrl = p["control"]
    assert ctrl["disabled_moves"] == 0 and ctrl["byte_exact"] is True
    for m in (p, j):
        for row in m["control"]["scenarios"].values():
            assert row["raised"] and row["cleared"] and row["in_bounds"]
            assert 0 < row["converge_ticks"] <= ctrl["tick_budget"]
            assert row["moves"] > 0
        assert m["value"] <= ctrl["tick_budget"]
    # on the CPU the wrappers take the plain versions and count nothing
    assert p["launches"] == {"gf_bit_matmul": 0, "mesh_xor": 0}
    assert _control_gate(p["name"], p["control"]) == []
    assert jax_control_gate(j["name"], j["control"]) == []


def test_measure_composed_chaos_equal(clean, members):
    j = jw.measure_composed_chaos(seeds=(24,))
    reset_both()
    p = pw.measure_composed_chaos(seeds=(24,), device="cpu")
    validate_metric(p)
    assert p.keys() == set(j) | {"launches"}
    assert p["chaos"] == j["chaos"]
    assert p["chaos"]["accepted"] is True
    assert p["stats"]["n"] == j["stats"]["n"] == 1
    assert _chaos_gate(p["name"], p["chaos"]) == []
    assert jax_chaos_gate(j["name"], j["chaos"]) == []
