"""The port's dispatch, pipeline and host-baseline workloads, its
regression gate, its bench CLI and ``tools/ec_benchmark`` against the JAX
package's, on the CPU.

Port side: ``ceph_tpu_torch.bench`` with ``device="cpu"`` (codecs on
``backend=host``); reference side: ``ceph_tpu.bench`` on its CPU
platform.  Timings differ between any two runs, so the workloads are
held to the JAX package's metric names and keys and to the schema, and
their correctness receipts (``identical``, the occupancy) to exact
values; the gate and the tool's non-timing output are held to exact
equality.
"""
import copy
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

import ceph_tpu.bench.regress as jregress
import ceph_tpu.bench.workloads as jw
from ceph_tpu.tools import ec_benchmark as jax_ecb

import ceph_tpu_torch.bench.regress as pregress
import ceph_tpu_torch.bench.workloads as pw
from ceph_tpu_torch.bench import __main__ as bench_cli
from ceph_tpu_torch.bench.schema import validate_metric
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.dispatch import g_dispatcher
from ceph_tpu_torch.gf.matrices import gf_gen_rs_matrix
from ceph_tpu_torch.ops import gf_pallas
from ceph_tpu_torch.tools import ec_benchmark as port_ecb

from torch_daemon_twin import one_thread  # noqa: F401 (a fixture)

MATRIX = gf_gen_rs_matrix(12, 8)
SMALL = dict(target_seconds=0.1, repeats=2, warmup=1)


def _shape(m):
    return (m["name"], m["unit"], m["fenced"], sorted(m), sorted(m["stats"]),
            sorted(m["roofline"]), sorted(m["devflow"]),
            sorted(m["stage_breakdown"]))


def _valid(m):
    validate_metric(m)
    assert m["fenced"] and not m["suspect"]
    assert m["platform"] == "cpu"


def test_dispatch_coalesce_metrics():
    gf_pallas.launches.reset()
    mc, ms = pw.measure_dispatch_coalesce(n_requests=4, device="cpu",
                                          **SMALL)
    jc, js = jw.measure_dispatch_coalesce(n_requests=4, **SMALL)
    assert _shape(mc) == _shape(jc) and _shape(ms) == _shape(js)
    for m in (mc, ms):
        _valid(m)
        assert m["n_requests"] == 4 and m["object_bytes"] == 65536
    assert mc["batch_occupancy"] == jc["batch_occupancy"] == 4
    assert mc["speedup"] > 0
    # coalesced: one flush stacks every request (dispatch.stack); serial:
    # the passthrough stacks nothing
    assert mc["devflow"]["host_copies"] > ms["devflow"]["host_copies"]
    assert gf_pallas.launches.n == 0        # the CPU takes plain versions
    # the options are restored and nothing is left queued
    assert g_conf.get_val("ec_dispatch_batch_window_us") == 0
    assert g_dispatcher.dump()["pending"] == 0


def test_pipeline_metrics_identical_and_occupancy():
    mp, m1 = pw.measure_ec_pipeline(n_requests=8, depth=4, device="cpu",
                                    **SMALL)
    jp, j1 = jw.measure_ec_pipeline(n_requests=8, depth=4, **SMALL)
    assert _shape(mp) == _shape(jp) and _shape(m1) == _shape(j1)
    for m in (mp, m1):
        _valid(m)
    assert mp["identical"] is True and jp["identical"] is True
    # one submitter, depth 4, 8 requests: every flush holds 4
    assert mp["mean_batch_occupancy"] == jp["mean_batch_occupancy"] == 4.0
    assert (mp["pipeline_depth"], m1["pipeline_depth"]) == (4, 1)


def test_host_native_metric():
    data = np.random.default_rng(3).integers(0, 256, (8, 16384),
                                             dtype=np.uint8)
    m = pw.measure_host_native(MATRIX, data, target_seconds=0.15)
    j = jw.measure_host_native(MATRIX, data, target_seconds=0.15)
    assert _shape(m) == _shape(j)
    _valid(m)
    assert m["name"] == "ec_encode_host_native"
    # the native coder never crosses to a device
    assert m["devflow"]["h2d_bytes"] == m["devflow"]["d2h_bytes"] == 0
    assert set(m["stage_breakdown"]["stages"]) == {"host_compute"}


def _metric(name, value, unit="GiB/s", **extra):
    m = {"schema_version": 1, "name": name, "value": value, "unit": unit,
         "fenced": True, "suspect": False}
    m.update(extra)
    return m


def _trajectory():
    """Synthetic rounds: a legacy one, another platform's, and two gpu
    rounds with devflow, stage, recovery and invariant blocks."""
    sb = {"stages": {"device_call": {"usec_per_op": 100.0},
                     "d2h": {"usec_per_op": 10.0}}}
    r3 = [_metric("enc", 700.0, devflow={"copies_per_op": 1.0,
                                         "bytes_per_op": 4096.0},
                  stage_breakdown=sb),
          _metric("remap", 1.6, unit="ms"),
          _metric("storm", 1.0, unit="ops/s",
                  recovery={"bytes_per_repaired_shard_regen": 1000.0,
                            "bytes_per_repaired_shard_rs": 4000.0,
                            "regen_vs_rs_ratio": 0.25})]
    r4 = copy.deepcopy(r3)
    r4[0]["value"] = 650.0
    return [
        {"round": 1, "path": "BENCH_r01.json", "parsed": None},
        {"round": 2, "path": "BENCH_r02.json",
         "parsed": {"platform": "tpu", "metrics": [_metric("enc", 9e9)]}},
        {"round": 3, "path": "BENCH_r03.json",
         "parsed": {"platform": "gpu", "metrics": r3}},
        {"round": 4, "path": "BENCH_r04.json",
         "parsed": {"platform": "gpu", "metrics": r4 + [
             _metric("broken", 1.0, fenced=False)]}},
    ]


def _current():
    sb = {"stages": {"device_call": {"usec_per_op": 200.0},
                     "batch_window": {"usec_per_op": 60.0},
                     "d2h": {"usec_per_op": 10.0}}}
    return [
        _metric("enc", 400.0, devflow={"copies_per_op": 2.0,
                                       "bytes_per_op": 100.0},
                stage_breakdown=sb),
        _metric("remap", 1.0, unit="ms"),
        _metric("storm", 1.0, unit="ops/s",
                recovery={"bytes_per_repaired_shard_regen": 2000.0,
                          "bytes_per_repaired_shard_rs": 4000.0,
                          "regen_vs_rs_ratio": 0.5}),
        _metric("new", 1.0),
        _metric("suspect", 1.0, suspect=True),
        _metric("skew", 1.0, skew={"detection_probes": 9,
                                   "detected_chip": 1, "slow_chip": 2}),
        _metric("strag", 1.0, straggler={"detection_probes": 2,
                                         "protected_p999_ratio": 3.0}),
        _metric("ctl", 1.0, control={"tick_budget": 5, "disabled_moves": 1,
                                     "scenarios": {"a": {"raised": True}}}),
        _metric("chaos", 1.0, chaos={"receipts": [{"seed": 24,
                                                   "byte_exact": False}]}),
        _metric("zc", 1.0, zero_copy={"resident_d2h_bytes_per_op": 600.0}),
    ]


@pytest.mark.parametrize("platform,tolerance", [("gpu", 0.30),
                                                ("gpu", 0.05),
                                                ("cpu", 0.30),
                                                ("tpu", 0.30)])
def test_compare_against_trajectory_equals_jax(platform, tolerance):
    cur = _current()
    want = jregress.compare_against_trajectory(
        copy.deepcopy(cur), _trajectory(), platform, tolerance=tolerance)
    got = pregress.compare_against_trajectory(
        copy.deepcopy(cur), _trajectory(), platform, tolerance=tolerance)
    assert got == want
    if platform == "gpu":
        assert got["compared"] == 3 and got["regressions"]
    if platform == "cpu":
        assert got["compared"] == 0


def test_load_trajectory_equals_jax(tmp_path):
    (tmp_path / "BENCH_r07.json").write_text(json.dumps(
        {"n": 7, "rc": 0, "parsed": {"platform": "gpu", "metrics": []}}))
    (tmp_path / "BENCH_r03.json").write_text("{not json")
    (tmp_path / "BENCH_r11.json").write_text(json.dumps({"n": 11}))
    (tmp_path / "BENCH_x.json").write_text("{}")
    got = pregress.load_trajectory(str(tmp_path))
    assert got == jregress.load_trajectory(str(tmp_path))
    assert [r["round"] for r in got] == [3, 7, 11]
    assert (pregress.DEFAULT_TOLERANCE, pregress.DEVFLOW_FLOORS) == \
        (jregress.DEFAULT_TOLERANCE, jregress.DEVFLOW_FLOORS)


def test_bench_cli_smoke_prints_one_schema_valid_line(capsys, one_thread):
    """``python -m ceph_tpu_torch.bench --smoke`` in this process: one
    JSON line on stdout, every metric schema-valid and fenced, the mesh
    workloads, the three cluster workloads and the two harnesses on top
    of the mesh run, and ``not_ported`` empty."""
    rc = bench_cli.main(["--smoke", "--gate", "warn"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert rc == 0, out
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert "error" not in line
    assert line["mode"] == "smoke" and line["platform"] == "cpu"
    names = [m["name"] for m in line["metrics"]]
    assert names == ["ec_encode_k8m4_fenced", "ec_decode_k8m4_e2_fenced",
                     "ec_dispatch_coalesce_fenced",
                     "ec_dispatch_serial_fenced", "ec_pipeline_fenced",
                     "ec_pipeline_depth1_fenced", "ec_mesh_fenced",
                     "ec_mesh_single_fenced", "ec_mesh_skew",
                     "ec_mesh_straggler", "ec_encode_host_native",
                     "traffic_harness_smoke", "ec_write_zero_copy",
                     "ec_recovery_storm", "ec_degraded_read",
                     "slo_autotune", "composed_chaos"]
    for m in line["metrics"]:
        validate_metric(m)
        assert m["fenced"] and not m["suspect"]
    assert line["decode_parity"] is True
    assert line["metrics"][4]["identical"] is True
    assert line["not_ported"] == list(bench_cli.NOT_PORTED) == []
    mesh = {m["name"]: m for m in line["metrics"]}
    assert mesh["ec_mesh_fenced"]["identical"] is True
    assert mesh["ec_mesh_fenced"]["mesh_chips"] == 8
    assert mesh["ec_mesh_skew"]["identical"] is True
    for name in ("ec_mesh_straggler", "ec_degraded_read"):
        assert mesh[name]["straggler"]["byte_identical"] is True
        assert mesh[name]["straggler"]["single_device_fallbacks"] == 0
    # the harnesses on top of the mesh, judged absolutely by regress.py's
    # CONTROL and CHAOS gates below
    ctrl = mesh["slo_autotune"]["control"]
    assert ctrl["disabled_moves"] == 0 and ctrl["byte_exact"] is True
    chaos = mesh["composed_chaos"]["chaos"]
    assert chaos["seeds"] == [24] and chaos["accepted"] is True
    # no TPU-era or CPU round carries a comparable fenced reading; the
    # mesh workloads' SKEW and STRAGGLER gates, and the CONTROL gate's
    # straggler scenario, judge wall-clock delays against the members'
    # service times on a CPU that other test workers share, so they are
    # gated on the card (chip_smoke.py 4w (d) and 4n)
    timed = ("ec_mesh_skew", "ec_mesh_straggler", "ec_degraded_read")
    assert [r for r in line["gate"]["regressions"]
            if r["name"].split(".")[0] not in timed
            and not r["name"].startswith(
                "slo_autotune.control.straggler.")] == []
    assert line["gate"]["platform"] == "cpu"
    for key in ("perf", "perf_histograms", "oplat", "devprof",
                "elapsed_s"):
        assert key in line


def _tool(mod, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().split()


@pytest.mark.parametrize("argv", [
    ["-p", "{isa}", "-P", "k=4", "-P", "m=2", "-S", "65536", "-i", "3"],
    ["-p", "{isa}", "-P", "k=4", "-P", "m=2", "-S", "65536", "-i", "2",
     "--batch", "4"],
    ["-p", "{tpu}", "-P", "k=8", "-P", "m=4", "-S", "131072", "-i", "2",
     "--dispatch", "4"],
    ["-p", "jerasure", "-P", "k=4", "-P", "m=2", "-S", "65536", "-i", "3",
     "-w", "decode", "-e", "2"],
    ["-p", "jerasure", "-P", "k=3", "-P", "m=2", "-S", "30000", "-i", "1",
     "-w", "decode", "--erasures-generation", "exhaustive", "-e", "2"],
    ["-p", "{tpu}", "-P", "k=4", "-P", "m=2", "-S", "4096", "-w", "decode",
     "--dispatch", "2"],
], ids=["encode", "batch", "dispatch", "decode", "exhaustive",
        "dispatch_decode_refused"])
def test_ec_benchmark_matches_jax(argv):
    """The tool's output equals the JAX tool's apart from the seconds:
    the same KiB column, the same exit code.  The port runs its codecs
    on ``backend=host``, the JAX package on its CPU."""
    port_argv = [a.format(isa="isa", tpu="cuda") for a in argv] \
        + ["-P", "backend=host"]
    jax_argv = [a.format(isa="isa", tpu="tpu") for a in argv] \
        + ["-P", "backend=host"]
    prc, pout = _tool(port_ecb, port_argv)
    jrc, jout = _tool(jax_ecb, jax_argv)
    assert prc == jrc
    assert pout[1::2] == jout[1::2]
    assert len(pout) == len(jout)
    if prc == 0:
        assert float(pout[0]) > 0
