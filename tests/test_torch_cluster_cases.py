"""The port's ``MiniCluster``, mgr, mesh-sharded EC and CRUSH, op queue,
invariant analyzer and chaos smoke against the JAX package's own cases,
on the CPU.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on: torch tensors where a
case builds jax values, a mesh whose members sit on 8 distinct devices
where a case reads the roofline's device scaling, the analyzer's rules
fed torch's calls, and no codec breakers.
"""
import pytest

import test_chaos
import test_cluster
import test_mgr
import test_parallel
import test_static_analysis
import test_work_queue
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_cluster, test_mgr, test_parallel, test_work_queue,
     test_static_analysis, test_chaos))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_cluster_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_cluster_cases_all_twinned():
    assert len(CASES) == 51
