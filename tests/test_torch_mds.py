"""The port's MDS (``mds/``, ``cephfs/mds_client.py``) against the JAX
package's, on the CPU.

Every case of ``tests/test_mds.py`` (metadata ops through the MDS,
capability revoke rounds serializing buffered writers, journal replay
after a crash, per-directory snapshots, failover retries and their
dedup, ``tell`` commands, the dual-writer fence) and of
``test_mds_multi.py`` (two active ranks on disjoint subtrees, forwards,
subtree handoffs draining caps, per-rank journals, the fsmap's ranks,
per-rank failover and ``max_mds``) runs on both packages with the same
inputs, ``uuid.uuid4`` and ``secrets.randbits`` drawn from seeded
sequences and the filesystem's ``time.time`` from one fake clock: each
package's run passes the case's own assertions, prints the same output,
every cluster stores the same objects (directory omaps, the MDS
journals, file data) on every OSD, and every monitor shows the same
fsmap (``fs_status``).  The clients drive the daemons
cooperatively from their blocked requests, as the JAX cases do: no
threads.
"""
import ast
import inspect

import pytest

import test_mds
import test_mds_multi
from torch_rbd_twin import (assert_same_runs, case_names, port_module,
                            run_both)

MODULES = {m.__name__: m for m in (test_mds, test_mds_multi)}
PORTS = {name: port_module(m) for name, m in MODULES.items()}
CASES = [(mod, case) for mod, m in MODULES.items()
         for case in case_names(m)]


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}::{c}" for m, c in CASES])
def test_mds_case_equal(mod, name, tmp_path, capsys):
    j, p = run_both(MODULES[mod], name, tmp_path, capsys,
                    port=PORTS[mod])
    assert j.clusters
    assert_same_runs(j, p)
    assert [c.mon.fs_status() for c in p.clusters] == \
        [c.mon.fs_status() for c in j.clusters]


def test_twins_run_the_ports_mds():
    """The twin modules hold the port's daemon and client, and the
    daemon's subtree lookup catches only what the path split raises."""
    from ceph_tpu_torch.cephfs.mds_client import RemoteCephFS
    from ceph_tpu_torch.mds import MDSDaemon
    from ceph_tpu_torch.mds import server
    assert PORTS["test_mds"].MDSDaemon is MDSDaemon
    assert PORTS["test_mds_multi"].RemoteCephFS is RemoteCephFS
    fn = next(n for n in ast.walk(ast.parse(inspect.getsource(server)))
              if isinstance(n, ast.FunctionDef) and n.name == "_auth_rank")
    caught = [h.type.id for h in ast.walk(fn)
              if isinstance(h, ast.ExceptHandler)]
    assert caught == ["FsError", "FsError"]
