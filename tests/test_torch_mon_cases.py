"""The port's monitors and mgr (``mon/``, ``mgr/``) against the JAX
package's own cases, on the CPU: elections, Paxos replication and leader
failover among three in-process monitors, the cluster log and
config-key store, the PG autoscaler, ``tell``/``injectargs`` over the
admin socket and the wire, and the mgr's HTTP routes.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on.
"""
import pytest

import test_logmon_configkey
import test_mgr_http
import test_multimon
import test_pg_autoscaler
import test_tell_injectargs
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_multimon, test_logmon_configkey, test_pg_autoscaler, test_tell_injectargs,
     test_mgr_http))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_mon_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_mon_cases_all_twinned():
    assert len(CASES) == 38
