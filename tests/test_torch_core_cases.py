"""The port's core libraries against the JAX package's own cases, on the
CPU: cephx and the TCP frames' auth (``auth/``), the dencoder, ``ecutil``,
the EC plugin registry and codecs, GF(2^8) and the jerasure bitmatrix
codes, lockdep, the fault-site registry and wall-clock mClock.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions and prints the same output.  Where the port differs
by design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on, or, where it checks
nothing else, is listed in ``torch_case_twin.NOT_RUN``.
"""
import pytest

import test_auth
import test_dencoder
import test_ec_plugins
import test_ecutil
import test_fault
import test_gf
import test_jerasure_bitmatrix
import test_lockdep
import test_qos_wall
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_auth, test_dencoder, test_ecutil, test_ec_plugins,
     test_gf, test_jerasure_bitmatrix, test_lockdep, test_fault,
     test_qos_wall))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_core_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_core_cases_all_twinned():
    assert len(CASES) == 181


def test_by_design_table_rests_on_roadmap():
    """Every reason of ``BY_DESIGN`` and ``NOT_RUN`` is the heading of an
    entry under "By design, pinned" in ``ROADMAP.md``."""
    import os

    from torch_case_twin import BY_DESIGN, NOT_RUN
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ROADMAP.md")
    with open(path) as f:
        text = f.read()
    pinned = text[text.index("**By design, pinned.**"):
                  text.index("**By design, not pinned.**")]
    reasons = {e[2] for edits in BY_DESIGN.values() for e in edits}
    reasons |= set(NOT_RUN.values())
    missing = [r for r in sorted(reasons) if f"**{r}**" not in pinned]
    assert not missing, missing
