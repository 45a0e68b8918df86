"""The port's bench harness, device-flow profiler, observability core and
traffic generator against the JAX package's own cases, on the CPU: the
fence, the roofline verdicts, the schema and the regression gate, the
``--smoke`` CLI and its workloads, the devflow ledger, histograms, span
trees, the zero-sync write path, and closed- and open-loop traffic with
dmClock and admission.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on, or, where it checks
nothing else, is listed in ``torch_case_twin.NOT_RUN``; the portable part
of each such case runs below as a case of its own on torch tensors.
"""
import time
from types import SimpleNamespace

import pytest
import torch

import test_bench_harness
import test_devprof
import test_load
import test_observability
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_bench_harness, test_devprof, test_observability, test_load))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_bench_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_bench_cases_all_twinned():
    assert len(CASES) == 70


def _copy_watched(on_copy):
    """An int32 tensor whose host copies call ``on_copy(tensor)`` first."""
    class Watched(torch.Tensor):
        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            if func is torch.Tensor.cpu:
                on_copy(args[0])
            return super().__torch_function__(func, types, args,
                                              kwargs or {})
    return torch.arange(8, dtype=torch.int32).as_subclass(Watched)


def test_fenced_timer_waits_for_the_drain_copy():
    """``test_bench_harness::test_fenced_timer_waits_for_materialization``
    on a tensor: the clock stops only after the host copy of the last
    output returns, however fast the launches returned."""
    from ceph_tpu_torch.bench import fence
    DELAY = 0.15

    def step(i):
        ready_at = time.perf_counter() + DELAY
        return _copy_watched(
            lambda t: time.sleep(max(ready_at - time.perf_counter(), 0.0)))

    timing = fence.fenced_time(step, n_steps=3, rtt_s=0.0)
    assert timing.elapsed_s >= DELAY * 0.95
    assert timing.fenced is True and timing.n_steps == 3


def test_drain_copies_one_element_to_the_host():
    """``test_bench_harness::test_drain_touches_host_bytes`` on a tensor:
    ``drain`` copies the output to the host, one element of it."""
    from ceph_tpu_torch.bench import fence
    copied = []
    fence.drain(_copy_watched(lambda t: copied.append(t.numel())))
    assert copied == [1]


def test_compile_counts_in_the_active_stage(monkeypatch, tmp_path):
    """``test_devprof::test_compile_detection_attributes_to_stage`` on
    the port's compiles: a fresh build (one nvcc run, stood in for by a
    script that writes the library) counts one compile under the active
    stage, on the profiler and its perf counter; a cached build adds
    nothing."""
    import ceph_tpu_torch.ops._build as build
    from ceph_tpu_torch.trace.devprof import (devprof_perf_counters,
                                              g_devprof, l_devprof_compiles)

    def fake_run(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "subprocess", SimpleNamespace(run=fake_run))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_logs", {})
    pc = devprof_perf_counters()
    before = pc.get(l_devprof_compiles)
    site0 = g_devprof.dump()["sites"].get(
        "unit.compile_probe", {}).get("compiles", 0)
    with g_devprof.stage("unit.compile_probe"):
        build.build("crc32c")
    after_first = pc.get(l_devprof_compiles)
    assert after_first == before + 1
    assert g_devprof.dump()["sites"]["unit.compile_probe"]["compiles"] \
        == site0 + 1
    with g_devprof.stage("unit.compile_probe"):
        build.build("crc32c")
    assert pc.get(l_devprof_compiles) == after_first
