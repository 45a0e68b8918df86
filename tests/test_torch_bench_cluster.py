"""The port's three cluster workloads of the bench against the JAX
package's, at the JAX CLI's smoke shapes, on the CPU.

- ``measure_traffic`` (8 clients x 32 ops, replicated): equal op tallies,
  byte-exactness and metric keys;
- ``measure_ec_write_zero_copy`` (6 objects): the ``zero_copy`` block
  equal but for the port's own ``launches`` receipt and the resident
  leg's crc32c table upload, which the port accounts on the card only
  (ROADMAP Queue 3, "Devprof bytes at three sites"); regress.py's
  ZERO-COPY gate clear in both;
- ``measure_recovery_storm`` (6 objects, 8 ops per client): the same
  victim, equal bytes moved per repaired shard for both families,
  identical read-backs.

The port's EC pools take ``device="cpu"`` (``backend=host``); the JAX
ones ``plugin=tpu`` on its CPU platform.
"""
import pytest

import ceph_tpu.ops.crc32c_device as jcrc
from ceph_tpu.bench import workloads as jw
from ceph_tpu.bench.regress import _zero_copy_gate as jax_gate

from ceph_tpu_torch.bench import workloads as pw
from ceph_tpu_torch.bench.regress import _zero_copy_gate
from ceph_tpu_torch.bench.schema import validate_metric

from torch_daemon_twin import clean  # noqa: F401

# the crc32c lookup tables the JAX resident leg uploads (the port's plain
# CPU version reads host tables)
CRC_TABLE_BYTES = 8 * 256 * 4


def test_measure_traffic_equal(clean):
    j = jw.measure_traffic(n_clients=8, ops_per_client=32)
    p = pw.measure_traffic(n_clients=8, ops_per_client=32)
    validate_metric(p)
    assert p.keys() == j.keys()
    for key in ("name", "unit", "n_clients", "total_ops", "completed",
                "byte_exact", "rounds", "throttled_total",
                "admission_rejections", "max_intake_depth", "errors"):
        assert p[key] == j[key], key
    assert p["byte_exact"] is True and p["completed"] == 256
    assert {c: {k: v for k, v in st.items() if k in ("issued", "completed")}
            for c, st in p["per_client"].items()} == \
        {c: {k: v for k, v in st.items() if k in ("issued", "completed")}
         for c, st in j["per_client"].items()}
    assert p["cluster_rollup"].keys() == j["cluster_rollup"].keys()
    assert p["cluster_rollup"]["oplat_p99_usec"].keys() == \
        j["cluster_rollup"]["oplat_p99_usec"].keys()


def test_measure_ec_write_zero_copy_equal(clean, monkeypatch):
    # the JAX package uploads its crc32c tables once per process: drop
    # them so that this run uploads (and accounts) them whatever ran
    # earlier in the process
    monkeypatch.setattr(jcrc, "_tables_dev", None)
    j = jw.measure_ec_write_zero_copy(n_objects=6)
    p = pw.measure_ec_write_zero_copy(n_objects=6, device="cpu")
    validate_metric(p)
    assert p.keys() == j.keys()
    pz, jz = dict(p["zero_copy"]), dict(j["zero_copy"])
    launches = pz.pop("launches")
    assert set(launches) == {"resident", "bytes_twin"}
    # on the CPU the wrappers take the plain versions and count nothing
    assert all(n == 0 for leg in launches.values() for n in leg.values())
    pres, jres = dict(pz.pop("resident")), dict(jz.pop("resident"))
    jres.pop("compiles")
    pres.pop("compiles")
    assert jres["h2d_bytes"] - pres["h2d_bytes"] == CRC_TABLE_BYTES
    assert jres["transfers"] - pres["transfers"] == 1
    for key in ("d2h_bytes", "host_copies"):
        assert pres[key] == jres[key], key
    ptwin, jtwin = dict(pz.pop("bytes_twin")), dict(jz.pop("bytes_twin"))
    ptwin.pop("compiles")
    jtwin.pop("compiles")
    assert ptwin == jtwin
    assert pz.pop("resident_copies_per_op") < pz["twin_copies_per_op"]
    jz.pop("resident_copies_per_op")
    assert pz == jz
    assert pz["byte_exact"] is True and pz["resident_shards"] > 0
    assert _zero_copy_gate(p["name"], p["zero_copy"]) == []
    assert jax_gate(j["name"], j["zero_copy"]) == []


def test_measure_recovery_storm_equal(clean):
    j = jw.measure_recovery_storm(n_objects=6, ops_per_client=8)
    p = pw.measure_recovery_storm(n_objects=6, ops_per_client=8,
                                  device="cpu")
    validate_metric(p)
    assert p.keys() == j.keys()
    for key in ("name", "unit", "value", "k", "m", "d", "victim_osd",
                "identical", "byte_exact_traffic", "traffic_completed",
                "recovery", "errors"):
        assert p[key] == j[key], key
    assert p["identical"] is True and p["byte_exact_traffic"] is True
    rec = p["recovery"]
    assert 0 < rec["regen_vs_rs_ratio"] < 1
    assert rec["families"]["pm-regen"]["repair_fallbacks"] == 0
    assert p["slo"] == j["slo"]


def test_cluster_workloads_need_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA"):
        pw.measure_ec_write_zero_copy(n_objects=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pw.measure_recovery_storm(n_objects=1)
