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
