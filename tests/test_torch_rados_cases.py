"""The port's OSD data path against the JAX package's own RADOS cases,
on the CPU: partial overwrites (``osd/ec_backend.py``'s read-modify-write),
divergent EC writes, the PG log and its delta recovery
(``osd/pg_log.py``), op vectors, pool and self-managed snapshots, watch
and notify, shallow and deep scrub, PG splits with pgp migration,
``pg_temp`` and PG removal (``osd/pg.py``).

Every case of the JAX modules below, each parametrised variant on its
own, runs on both packages with the same inputs
(``torch_case_twin.assert_case_equal``): each package's run passes the
case's own assertions, prints the same output, and every cluster the case
builds stores the same objects on every OSD.  Where the port differs by
design, the case runs with the edit of ``torch_case_twin.BY_DESIGN``
that names the ``ROADMAP.md`` entry it rests on.
"""
import pytest

import test_deep_scrub
import test_ec_divergent
import test_op_vector
import test_pg_log
import test_pg_removal
import test_pg_split
import test_pg_temp
import test_rmw
import test_scrub
import test_selfmanaged_snaps
import test_snapshots
import test_watch_notify
from torch_case_twin import assert_case_equal, case_ids, twin_table

MODULES, PORTS, CASES = twin_table(
    (test_rmw, test_ec_divergent, test_pg_log, test_op_vector,
     test_snapshots, test_selfmanaged_snaps, test_watch_notify, test_scrub,
     test_deep_scrub, test_pg_split, test_pg_temp, test_pg_removal))


@pytest.mark.parametrize("mod,name,vid,params", CASES, ids=case_ids(CASES))
def test_rados_case_equal(mod, name, vid, params, tmp_path, capsys):
    assert_case_equal(MODULES, PORTS, mod, name, params, tmp_path, capsys)


def test_rados_cases_all_twinned():
    assert len(CASES) == 119


def test_osds_map_each_pg_through_crush_once_per_crush_input(monkeypatch):
    """``OSD.pg_mapping`` asks CRUSH once per crush map content and
    CRUSH input (rule, pps, size, weights, choose_args), shared by every
    OSD whose map reads the same: epochs that move only up/down state,
    pg_temp or a pool's snapshots map their PGs without CRUSH, a crush map
    edited in place maps each PG once for all the OSDs that hold it at
    their next epoch, and every answer equals the map's own
    ``pg_to_up_acting_osds``.  Before, each pg_temp epoch after a PG
    split (one per pinned PG as its migration ends, ``chip_smoke.py`` 4r
    (c)) cost every OSD a full host-CRUSH pass."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.crush.wrapper import CrushWrapper
    from ceph_tpu_torch.osdmap import pg_t

    calls = []
    do_rule = CrushWrapper.do_rule

    def counted(self, *a, **kw):
        calls.append((*a[:3], tuple(a[3]), kw.get("choose_args_index")))
        return do_rule(self, *a, **kw)

    monkeypatch.setattr(CrushWrapper, "do_rule", counted)
    c = MiniCluster(n_osds=6)
    pid = c.create_ec_pool("p", k=2, m=2, plugin="cuda", pg_num=8,
                           extra_profile={"backend": "host"})
    cl = c.client("client.m")
    assert cl.write_full("p", "o", b"x" * 5000) == 0

    def check_all():
        for osd in c.osds.values():
            for ps in range(8):
                assert osd.pg_mapping((pid, ps)) == tuple(
                    osd.osdmap.pg_to_up_acting_osds(pg_t(pid, ps)))

    check_all()
    calls.clear()
    before = {i: o.osdmap.epoch for i, o in c.osds.items()}

    def map_all():
        for osd in c.osds.values():
            for ps in range(8):
                osd.pg_mapping((pid, ps))

    c.kill_osd(3)
    c.mark_osd_down(3)
    c.revive_osd(3)
    assert all(o.osdmap.epoch >= before[i] + 2 for i, o in c.osds.items())
    map_all()
    assert calls == []              # up/down epochs: no CRUSH at all
    assert cl.selfmanaged_snap_create("p") > 0
    map_all()
    # a snapshot's epoch publishes a fresh copy of the same crush map
    assert calls == []
    assert cl.read("p", "o") == b"x" * 5000

    # a crush map edited in place: the next epoch maps with the edit, one
    # CRUSH pass per PG shared by the OSDs holding that map
    crush = c.osds[0].osdmap.crush
    holders = [o for o in c.osds.values() if o.osdmap.crush is crush]
    assert len(holders) == 6
    was = {ps: c.osds[0].pg_mapping((pid, ps))[0] for ps in range(8)}
    assert any(5 in up for up in was.values())
    crush.adjust_item_weight(5, 0)
    c.kill_osd(3)
    c.mark_osd_down(3)
    c.revive_osd(3)
    map_all()
    # each PG's input once for the six OSDs (the monitor, which kept the
    # map as it was, may ask CRUSH itself)
    assert len(set(calls)) == 8 and len(calls) < 2 * 8
    for osd in holders:
        for ps in range(8):
            assert 5 not in osd.pg_mapping((pid, ps))[0]
    monkeypatch.setattr(CrushWrapper, "do_rule", do_rule)
    check_all()
