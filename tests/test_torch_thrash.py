"""The JAX package's thrash cases on the port, on the CPU.

``test_vstart_thrash.py`` kills and revives monitors (and the active MDS
beside the monitor leader) of a ``ProcessCluster`` whose daemons are
processes over TCP, with client writes going on; its port runs on the
port's ``ProcessCluster`` with every daemon on ``device="cpu"``.
``test_workloads_thrash.py`` runs rbd, cephfs and rgw (versioned, beside
an MDS crash-replay) on one ``MiniCluster`` while OSDs are killed, marked
out and revived.

Only the port's side runs here: the JAX files run the JAX side.  The
cases' own assertions are the check (every write lands, every read
equals what was written, the standby MDS takes rank 0, fsck and gc find
nothing); their waits are on the wall clock, so no output is compared.
"""
import pytest

import test_vstart_thrash
import test_workloads_thrash
from torch_rbd_twin import PORT, case_names, port_module, run_one

MODULES = {
    "test_vstart_thrash": port_module(
        test_vstart_thrash,
        edits=[("ProcessCluster(\n", "ProcessCluster(device=\"cpu\",\n")]),
    "test_workloads_thrash": port_module(test_workloads_thrash),
}
# the compound kill waits out an election and the MDS grace on the wall
# clock: it runs from its own file (test_torch_thrash_mds.py), so that
# each file stays well inside a worker's share of the suite's time
COMPOUND = ("test_vstart_thrash", "test_mon_leader_and_active_mds_die_together")
CASES = [(mod, case) for mod, m in MODULES.items() for case in case_names(m)
         if (mod, case) != COMPOUND]


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}::{c}" for m, c in CASES])
def test_thrash_case_on_the_port(mod, name, tmp_path, capsys):
    run = run_one(MODULES[mod], name, PORT, tmp_path, capsys)
    assert "Traceback" not in run.err


def test_thrash_cases_run_the_ports_daemons():
    """Both modules hold the port's clusters, and every case of the two
    JAX files is run, here or (the compound kill) beside."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.vstart import ProcessCluster
    assert MODULES["test_vstart_thrash"].ProcessCluster is ProcessCluster
    assert MODULES["test_workloads_thrash"].MiniCluster is MiniCluster
    assert sorted(CASES + [COMPOUND]) == sorted(
        (mod, case) for mod, m in MODULES.items() for case in case_names(m))
    assert len(CASES) == 3
