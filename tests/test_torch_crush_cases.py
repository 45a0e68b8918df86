"""The port's host CRUSH (``crush/``) against the JAX package's own
cases, on the CPU: the core mapper, hash and ln tables, weight sets
(choose_args) with the balancer's crush-compat mode, and CRUSH
locations.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions and prints the same output.  Where the port differs
by design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on.
"""
import pytest

import test_crush_compat
import test_crush_core
import test_crush_location
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_crush_core, test_crush_compat, test_crush_location))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_crush_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_crush_cases_all_twinned():
    assert len(CASES) == 26
