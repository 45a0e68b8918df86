"""``test_vstart_thrash.py``'s compound kill on the port, on the CPU: the
monitor leader and the active MDS of the port's ``ProcessCluster``
(daemons on ``device="cpu"``) SIGKILLed in one instant; a new leader
forms quorum, the standby takes rank 0 after the MDS grace and serves
the journaled namespace.  The port's side only, as in
``test_torch_thrash.py``, whose harness it shares."""
from test_torch_thrash import COMPOUND, MODULES
from torch_rbd_twin import PORT, run_one


def test_compound_kill_on_the_port(tmp_path, capsys):
    mod, name = COMPOUND
    run = run_one(MODULES[mod], name, PORT, tmp_path, capsys)
    assert "Traceback" not in run.err
