"""The port's write pipeline, op queues and controller against the JAX
package's own cases, on the CPU: the pipelined EC write, the threaded
op queue, wall-clock mClock, recovery storms with regenerating repair,
and the SLO controller's reflexes and liveness.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on.
"""
import pytest

import test_control
import test_control_liveness
import test_control_loop
import test_mclock_wall
import test_pipeline
import test_recovery_storm
import test_threaded_wq
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_pipeline, test_threaded_wq, test_mclock_wall, test_recovery_storm,
     test_control, test_control_loop, test_control_liveness))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_pipeline_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_pipeline_cases_all_twinned():
    assert len(CASES) == 50


def test_cpu_block_service_is_its_calls_cpu_time(monkeypatch):
    """A rateless flush on CPU members records each chip's delta as the
    CPU time of its block's call (plus an injected hold), not the wall
    clock to the drain's first poll, nor to the call's return.  The
    launch loop runs every CPU call to its end before the drain polls,
    so stamping the poll charged each block every later block's call:
    on a loaded host the first chips read more than a 30 ms straggler,
    and ``test_control_loop.py``'s straggler case never raised
    TPU_MESH_SKEW on the port while JAX's did.  Stamping the call's
    return charged a call the time a loaded host gave other processes:
    a storyline's flushes raised TPU_MESH_SKEW with no straggler
    (``test_torch_chaos.py::test_run_seed_composes_and_runs`` under
    load).  Probe flushes of 8 members whose calls sleep (wall time, no
    CPU time): with chip 5 held 30 ms, every other chip reads no more
    than its longest call (plus 1 ms) and chip 5 breaches the skew
    threshold over their median (its delta, or the drain's censored
    floor); with no hold and one call in eight sleeping 30 ms, no chip
    breaches."""
    import statistics
    import time

    import numpy as np
    import torch

    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import g_dispatcher
    from ceph_tpu_torch.ec.cuda_plugin import ErasureCodeCuda
    from ceph_tpu_torch.fault import g_faults
    from ceph_tpu_torch.mesh import (g_chipstat, members_per_device,
                                     set_members_per_device)
    from ceph_tpu_torch.ops import gf_pallas
    from ceph_tpu_torch.osd.ecutil import stripe_info_t
    from torch_daemon_twin import reset_both

    kernel = gf_pallas.gf_bit_matmul_kernel
    calls = []
    sleeps = [0.005]

    def held(data, bm):
        t0 = time.perf_counter()
        time.sleep(sleeps[len(calls) % len(sleeps)])
        out = kernel(data, bm)
        calls.append((time.perf_counter() - t0) * 1e6)
        return out

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = members_per_device()
    set_members_per_device(8)
    reset_both(collect=False)
    try:
        for name, value in (("ec_mesh_chips", 8),
                            ("ec_dispatch_batch_window_us", 10_000_000),
                            ("ec_mesh_skew_sample_every", 1),
                            ("ec_mesh_rateless", True)):
            g_conf.set_val(name, value)
        threshold = float(g_conf.get_val("ec_mesh_skew_threshold"))
        impl = ErasureCodeCuda()
        impl.init({"k": "4", "m": "2", "backend": "host"})
        sinfo = stripe_info_t(4, 4 * 1024)
        rng = np.random.default_rng(7)

        def flush():
            g_chipstat.reset()
            futs = [g_dispatcher.submit_encode(
                sinfo, impl, rng.integers(0, 256, 8 * 4096, dtype=np.uint8),
                set(range(6))) for _ in range(3)]
            g_dispatcher.flush()
            for f in futs:
                f.result()
            per_chip = {int(i): row["last_usec"]
                        for i, row in g_chipstat.dump()["per_chip"].items()}
            assert sorted(per_chip) == list(range(8))
            return per_chip

        flush()
        monkeypatch.setattr(gf_pallas, "gf_bit_matmul_kernel", held)
        g_faults.inject("mesh.chip_slowdown", mode="always",
                        match="chip=5/", delay_us=30_000)
        per_chip = flush()
        assert len(calls) >= 8
        longest = max(calls)
        others = [v for i, v in per_chip.items() if i != 5]
        assert all(v <= longest + 1000 for v in others), (per_chip, calls)
        assert per_chip[5] >= threshold * statistics.median(others), per_chip

        g_faults.clear()
        calls.clear()
        sleeps[:] = [0.030] + [0.001] * 7
        per_chip = flush()
        assert max(calls) >= 30_000
        median = statistics.median(per_chip.values())
        assert all(v < threshold * median for v in per_chip.values()), \
            (per_chip, calls)
    finally:
        reset_both(collect=False)
        set_members_per_device(before)
        torch.set_num_threads(threads)
