"""The port's telemetry (``trace/``, ``mgr/``, ``arch.py``) against the
JAX package's own cases, on the CPU: the Prometheus exposition and its
agreement with every dump, leveled logging and the kernel timer, the
``arch probe`` answer, the stage-latency ledger and the common
helpers.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on.
"""
import pytest

import test_common
import test_dout_trace
import test_oplat
import test_prometheus_exposition
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_prometheus_exposition, test_dout_trace, test_oplat, test_common))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_telemetry_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_telemetry_cases_all_twinned():
    assert len(CASES) == 48


def test_arch_probe_answers_the_jax_keys():
    """``arch probe`` (``ceph_tpu_torch/arch.py``, the admin socket's
    ``arch probe``) answers every key of the JAX probe with the same
    meaning: on a CPU-only host ``platform`` and ``device_kind`` read
    ``cpu`` as JAX's do, ``x64``, ``native`` and ``pallas`` equal JAX's,
    and the answer is cached.  ``n_devices`` counts torch's devices (the
    host is one; JAX's test platform has 8 virtual ones).  It answered
    ``platform`` ``none``, no ``native`` and ``device_name`` for
    ``device_kind`` before (``test_dout_trace.py::test_arch_probe_shape``
    and ``::test_cluster_admin_log_and_trace_commands``)."""
    from ceph_tpu import arch as jax_arch
    from ceph_tpu_torch import arch
    j, p = jax_arch.probe(), arch.probe()
    assert set(j) <= set(p)
    assert {k: p[k] for k in j if k != "n_devices"} == \
        {k: j[k] for k in j if k != "n_devices"}
    assert p["n_devices"] == 1
    assert arch.probe() is p and arch.probe(refresh=True) == p
