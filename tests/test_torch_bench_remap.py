"""The port's fenced CRUSH remap against the JAX package's, on the CPU.

Port side: ``ceph_tpu_torch.bench.workloads.measure_crush_remap`` with
``device="cpu"`` (K7a, K7b and K6's plain versions); reference side:
``ceph_tpu.bench.workloads.measure_crush_remap`` on the CPU.  Both map a
100-OSD map (5 hosts of 20) with 2000 PGs; the metrics must carry the
JAX package's names and keys, the residual fraction must equal the JAX
``compile_fast_rule``'s, and the per-epoch wall region must move the
same bytes.
"""
import numpy as np
import pytest

import ceph_tpu.bench.workloads as jw

import ceph_tpu_torch.bench.workloads as pw
from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.ops.crush_fast import compile_fast_rule

ARGS = dict(n_osds=100, n_pgs=2000, epochs=3)


@pytest.fixture(scope="module")
def runs():
    jkeys, pkeys = {}, {}
    j = jw.measure_crush_remap(uniform=True, partial=jkeys.update, **ARGS)
    p = pw.measure_crush_remap(uniform=True, partial=pkeys.update,
                               device="cpu", **ARGS)
    return j, p, jkeys, pkeys


def test_remap_metrics_carry_the_jax_names_and_keys(runs):
    j, p, _, _ = runs
    assert len(p) == len(j) == 6
    assert [m["name"] for m in p[5]] == [m["name"] for m in j[5]] == [
        "crush_remap_device", "crush_remap_wall"]
    for pm, jm in zip(p[5], j[5]):
        assert sorted(pm) == sorted(jm)
        assert (pm["unit"], pm["fenced"], pm["pgs"], pm["n_osds"]) == \
            (jm["unit"], jm["fenced"], jm["pgs"], jm["n_osds"])
        assert sorted(pm["stats"]) == sorted(jm["stats"])
        assert pm["value"] > 0
    # the wall region: the weights up and the changed rows back, per epoch
    pw_flow, jw_flow = p[5][1]["devflow"], j[5][1]["devflow"]
    for k in ("h2d_bytes", "d2h_bytes", "transfers", "copies_per_op"):
        assert pw_flow[k] == jw_flow[k]
    # the sustained region moves nothing but its unaccounted drain
    assert p[5][0]["devflow"]["transfers"] == 0
    assert sorted(p[5][0]["stage_breakdown"]["stages"]) == ["d2h",
                                                            "device_call"]


def test_residual_fraction_equals_jax_compile_fast_rule(runs):
    j, p, _, _ = runs
    assert p[3] == j[3]
    assert p[2] is None                  # no native host baseline yet


def test_partial_keys(runs):
    _, _, jkeys, pkeys = runs
    # the reference adds its native host baseline where its library is
    # built; the port reports the x recomputed on the host (none)
    jkeys.pop("crush_remap_native_host_ms", None)
    assert sorted(set(pkeys) - {"crush_host_replayed"}) == sorted(jkeys)
    assert pkeys["crush_host_replayed"] == 0
    assert pkeys["crush_residual_fraction"] == jkeys[
        "crush_residual_fraction"]


def test_remap_rows_equal_crush_do_rule():
    cw, rno = pw.remap_crush_map(100, uniform=False)
    fr = compile_fast_rule(cw.crush, rno, 3, device="cpu")
    xs = np.arange(500, dtype=np.uint32)
    w = np.full(100, 0x10000, np.uint32)
    w[17] = 0
    res, cnt = fr.map_batch(xs, w)
    wl = [int(v) for v in w]
    for x in xs[::7]:
        assert [int(v) for v in res[x, :cnt[x]]] == \
            crush_do_rule(cw.crush, rno, int(x), 3, wl)
