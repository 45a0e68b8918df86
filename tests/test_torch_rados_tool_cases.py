"""The port's pools, client and tools against the JAX package's own
RADOS cases, on the CPU: pool deletion, PG listing, store and cluster
checkpoints, quotas and the full flag, the striper with the ``rados`` and
``ceph`` tools, ``cls_lock``, the snap mapper and cache tiering.

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on.
"""
import pytest

import test_cache_tier
import test_cls_lock
import test_durability
import test_pgls
import test_pool_delete
import test_quota_full
import test_snap_mapper
import test_striper_radoscli
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_pool_delete, test_pgls, test_durability, test_quota_full,
     test_striper_radoscli, test_cls_lock, test_snap_mapper, test_cache_tier))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_rados_tool_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_rados_tool_cases_all_twinned():
    assert len(CASES) == 54
