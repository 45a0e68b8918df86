"""The port's counters and incident forensics against the JAX package's
own cases, on the CPU: every perf counter and histogram family exported,
the event journal, incident capture and the chaos storyline's bundle.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on.
"""
import pytest

import test_counter_coverage
import test_incident
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_counter_coverage, test_incident))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_incident_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_incident_cases_all_twinned():
    assert len(CASES) == 10


def test_twins_leave_the_jax_mesh_counters_as_found():
    """The mesh counter loggers are process-global.  A twin's JAX side
    runs JAX code, and a degraded-read fallback it counted stayed in the
    worker, where ``test_counter_coverage.py``'s canary (``mesh_decode``
    ``fallbacks == 0``) then failed, in the JAX file and in its twin
    here alike, whenever ``test_torch_mesh_decode.py`` had run earlier
    in the same worker.  Each twin now runs against zeroed counters on
    both packages and leaves them as it found them."""
    from ceph_tpu.mesh import mesh_decode_perf_counters as jax_mdec
    from ceph_tpu.mesh.runtime import l_mdec_fallbacks as jax_fb
    from ceph_tpu_torch.mesh import mesh_decode_perf_counters as mdec
    from ceph_tpu_torch.mesh.runtime import l_mdec_fallbacks as fb
    from torch_daemon_twin import fresh_mesh_counters
    before = jax_mdec().get(jax_fb), mdec().get(fb)
    with fresh_mesh_counters():
        assert (jax_mdec().get(jax_fb), mdec().get(fb)) == (0, 0)
        jax_mdec().inc(jax_fb)
        mdec().inc(fb)
    assert (jax_mdec().get(jax_fb), mdec().get(fb)) == before
