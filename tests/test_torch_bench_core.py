"""The port's bench core (stats, schema, roofline, fence) against the JAX
package's, on the CPU.

Port side: ``ceph_tpu_torch.bench``; reference side: ``ceph_tpu.bench``.
Both get the same seeded samples and records; summaries, metric records,
``SchemaError`` messages and roofline verdicts must be equal.  Timings are
the one thing two runs cannot share, so the fence is checked for its
contract (spans, oplat stamps, histogram, drain accounting) rather than
its numbers.
"""
import numpy as np
import pytest
import torch

import ceph_tpu.bench.roofline as jroof
import ceph_tpu.bench.schema as jschema
import ceph_tpu.bench.stats as jstats
import ceph_tpu.trace.devprof as jdevprof

import ceph_tpu_torch.bench as pbench
import ceph_tpu_torch.bench.fence as pfence
import ceph_tpu_torch.bench.roofline as proof
import ceph_tpu_torch.bench.schema as pschema
import ceph_tpu_torch.bench.stats as pstats
import ceph_tpu_torch.trace.devprof as pdevprof
import ceph_tpu_torch.trace.oplat as poplat
from ceph_tpu_torch.trace import g_perf_histograms, latency_axes


def test_summarize_and_repeat_measure_equal():
    rng = np.random.default_rng(31)
    for n in (1, 2, 5, 16):
        xs = [float(v) for v in rng.lognormal(3, 1, n)]
        assert pstats.summarize(xs) == jstats.summarize(xs)
    for mod in (pstats, jstats):
        with pytest.raises(ValueError):
            mod.summarize([])
        with pytest.raises(ValueError):
            mod.repeat_measure(lambda: 1.0, repeats=0)

    def feed(mod):
        it = iter(rng.random(9).tolist())
        return mod.repeat_measure(lambda: next(it), repeats=6, warmup=3)

    rng = np.random.default_rng(32)
    a = feed(pstats)
    rng = np.random.default_rng(32)
    assert a == feed(jstats)


def _records(mod):
    st = {"n": 3, "median": 2.5, "iqr": 0.125, "min": 2.0, "max": 3.0,
          "samples": [2.0, 2.5, 3.0], "warmup_samples": [9.0]}
    rl = {"verdict": "ok", "suspect": False, "mfu": 0.1}
    out = [mod.make_metric("enc", 512.123456, "GiB/s", fenced=True,
                           rtt_s=0.0001234, stats=st, roofline=rl,
                           extra={"n_steps": 8}),
           mod.make_metric("count", 0, "ops", fenced=False)]
    bad = [
        lambda: mod.make_metric("zero", 0.0, "ms", fenced=True),
        lambda: mod.make_metric("neg", -1.0, "ms", fenced=True),
        lambda: mod.make_metric("", 1.0, "ms", fenced=True),
        lambda: mod.make_metric("x", 1.0, "ms", fenced=True,
                                extra={"value": 2}),
        lambda: mod.make_metric("x", 1.0, "ms", fenced=True,
                                stats={"n": 0, "median": 1, "iqr": 0,
                                       "min": 1}),
        lambda: mod.make_metric("x", 1.0, "ms", fenced=True,
                                stats={"n": 2, "median": 1, "iqr": 0,
                                       "min": 2}),
        lambda: mod.make_metric("x", 1.0, "ms", fenced=True,
                                roofline={"verdict": "great"}),
        lambda: mod.validate_metric({"schema_version": 2, "name": "x",
                                     "value": 1, "unit": "s",
                                     "fenced": True}),
        lambda: mod.validate_metric({"schema_version": 1, "name": "x",
                                     "value": True, "unit": "s",
                                     "fenced": True}),
        lambda: mod.validate_metric({"schema_version": 1, "name": "x",
                                     "value": 1, "unit": "s",
                                     "fenced": 1}),
        lambda: mod.validate_metric({"schema_version": 1, "name": "x",
                                     "value": 1, "unit": "s",
                                     "fenced": True,
                                     "roofline": {"verdict": "suspect"},
                                     "suspect": False}),
        lambda: mod.validate_metric({"name": "x"}),
    ]
    errs = []
    for f in bad:
        with pytest.raises(mod.SchemaError) as ei:
            f()
        errs.append(str(ei.value))
    return out, errs


def test_make_and_validate_metric_equal_including_refusals():
    port, jax = _records(pschema), _records(jschema)
    assert port == jax
    assert "did not run" in port[1][0]       # an exact 0.0 time refused


def test_validate_reading_equal_and_the_h100_entry():
    for platform, kind in (("cpu", ""), ("tpu", "TPU v5 lite"),
                           ("tpu", ""), ("gpu", "unknown card")):
        for gibs in (0.5, 300.0, 5000.0):
            for wl in ("EC_ENCODE_K8M4", "EC_DECODE_K8M4"):
                assert proof.validate_reading(
                    gibs, getattr(proof, wl), platform, kind, 2) == \
                    jroof.validate_reading(gibs, getattr(jroof, wl),
                                           platform, kind, 2)
    assert proof.EC_ENCODE_K8M4 == jroof.EC_ENCODE_K8M4
    assert proof.EC_DECODE_K8M4 == jroof.EC_DECODE_K8M4
    # the port's H100 entry, matched on the card's name
    spec = proof.chip_spec("gpu", "NVIDIA H100 80GB HBM3")
    assert spec == {"int8_tops": 1979.0, "hbm_gibs": 3.35e12 / (1 << 30)}
    assert proof.H100_INT8_OPS_PER_S == 1979e12
    assert proof.H100_HBM_BYTES_PER_S == 3.35e12
    ok = proof.validate_reading(700.0, proof.EC_ENCODE_K8M4, "gpu",
                                "NVIDIA H100 80GB HBM3")
    assert ok["verdict"] == "ok" and ok["peak_tops"] == 1979.0
    # 4000 GiB/s of encode would need ~2199 TOPS: above the card's peak
    bad = proof.validate_reading(4000.0, proof.EC_ENCODE_K8M4, "gpu",
                                 "NVIDIA H100 80GB HBM3")
    assert bad["verdict"] == "suspect" and bad["suspect"]
    assert jroof.chip_spec("gpu", "NVIDIA H100 80GB HBM3") is None


@pytest.mark.parametrize("name,per_byte,ceiling", [
    ("EC_ENCODE_K8M4_SALTED", 3.5, 3.35e12 / (1 << 30) / 3.5),
    ("EC_DECODE_K8M4_SALTED", 3.25, 3.35e12 / (1 << 30) / 3.25)])
def test_salted_step_models_hold_the_port_to_its_bytes(name, per_byte,
                                                       ceiling):
    """The salted step moves the XOR's read and write of the batch and
    K1's read and r/k write: a reading above HBM over those bytes is
    suspect on the H100, one just under it is not."""
    wl = getattr(proof, name)
    assert wl["hbm_bytes_per_byte"] == per_byte and wl["ops_per_byte"] == 0
    kind = "NVIDIA H100 80GB HBM3"
    ok = proof.validate_reading(ceiling * 0.99, wl, "gpu", kind)
    bad = proof.validate_reading(ceiling * 1.01, wl, "gpu", kind)
    assert ok["verdict"] == "ok" and ok["mfu"] == 0.0
    assert bad["verdict"] == "suspect" and bad["suspect"]


def test_drain_accounts_one_element_as_jax_does(monkeypatch):
    for dt, np_dt in ((torch.uint8, np.uint8), (torch.int32, np.int32)):
        pp, jp = pdevprof.DevFlowProfiler(), jdevprof.DevFlowProfiler()
        monkeypatch.setattr(pfence, "g_devprof", pp)
        monkeypatch.setattr(jdevprof, "g_devprof", jp)
        pfence.drain(torch.zeros((3, 5), dtype=dt))
        from ceph_tpu.bench.fence import drain as jdrain
        jdrain(np.zeros((3, 5), dtype=np_dt))
        assert pp.dump()["sites"] == jp.dump()["sites"]
    with pytest.raises(AttributeError):
        pfence.drain(object())


def test_fenced_time_contract_on_cpu_tensors(monkeypatch):
    from ceph_tpu_torch.common.kernel_trace import g_kernel_timer
    from ceph_tpu_torch.trace import g_tracer
    acc = poplat.OpLatAccumulator()
    monkeypatch.setattr(poplat, "g_oplat", acc)
    snap = acc.snapshot()
    hist = g_perf_histograms.get("bench", "fenced_step_latency_histogram",
                                 latency_axes)
    n0 = hist.total_count
    steps = []
    g_tracer.enable()
    g_kernel_timer.enable()
    try:
        t = pbench.fenced_time(lambda i: steps.append(i) or
                               torch.full((4,), i), 5, rtt_s=1e-6,
                               kernel_name="bench_unit")
        spans = [s for ring in g_tracer.collector._rings.values()
                 for s in ring if s.name.startswith("bench_fence:")]
    finally:
        g_tracer.enable(False)
        g_kernel_timer.enable(False)
    assert steps == [0, 1, 2, 3, 4]
    assert t.fenced and t.n_steps == 5 and t.elapsed_s > 0
    assert t.to_dict()["fenced"] and t.per_step_s == t.elapsed_s / 5
    assert t.throughput(1 << 30) == pytest.approx(5 / t.elapsed_s)
    assert spans and spans[-1].name == "bench_fence:bench_unit"
    bd = acc.breakdown_since(snap, t.elapsed_s, 5)
    assert set(bd["stages"]) == {"device_call", "d2h"}
    assert bd["stages"]["device_call"]["count"] == 1
    assert hist.total_count == n0 + 1
    assert g_kernel_timer.dump()["bench_unit"]["calls"] >= 1
    with pytest.raises(ValueError):
        pbench.fenced_time(lambda i: torch.zeros(1), 0, rtt_s=1e-6)


def test_measure_rtt_on_cpu_is_positive():
    assert pbench.measure_rtt(device="cpu", repeats=3) > 0.0
