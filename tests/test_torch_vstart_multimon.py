"""The JAX package's three-monitor leader SIGKILL case on the port, on
the CPU.

``test_vstart_multimon.py`` starts a ``ProcessCluster`` of three mons and
three OSDs (each a process over TCP), binds a client to the peon mon.1,
writes, allocates three snapshot ids, SIGKILLs the leader mon.0 with a
relayed command in flight, waits for rank 1 to lead a quorum of two, and
then holds the survivors to one committed state and reads back what was
written under the old quorum.  Its port runs on the port's
``ProcessCluster`` with every daemon on ``device="cpu"``.

Only the port's side runs here: the JAX file runs the JAX side.  The
case's own assertions are the check; its waits are on the wall clock, so
no output is compared.
"""
import time

import test_vstart_multimon
from torch_rbd_twin import PORT, case_names, port_module, run_one

MODULE = port_module(
    test_vstart_multimon,
    edits=[("ProcessCluster(\n", "ProcessCluster(device=\"cpu\",\n")])


def test_leader_sigkill_case_on_the_port(tmp_path, capsys):
    run = run_one(MODULE, "test_three_mons_leader_sigkill_recovers", PORT,
                  tmp_path, capsys)
    assert "Traceback" not in run.err


def test_multimon_case_runs_the_ports_daemons():
    from ceph_tpu_torch.vstart import ProcessCluster
    assert MODULE.ProcessCluster is ProcessCluster
    assert case_names(MODULE) == ["test_three_mons_leader_sigkill_recovers"]


def test_osd_asks_the_sender_for_the_epochs_a_map_skips():
    """The cause of the port's timed-out read after the leader SIGKILL:
    the leader queues a freshly booted OSD's subscription reply and the
    epochs it commits behind its reconnect backoff, and dies with them;
    the OSDs stay at their boot epoch (still up in it, though the dead
    leader marked them down) and drop every later map, whose first epoch
    is past their next one.  Here an OSD of an in-process cluster misses
    two epochs; the third reaches it with a gap, and the OSD subscribes
    to the sender again and catches up to the mon's epoch."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.msg.messages import MMonSubscribe
    c = MiniCluster(n_osds=3)
    c.create_replicated_pool("p", size=3, pg_num=4)
    osd = c.osds[0]
    have = osd.osdmap.epoch
    handle = osd._handle_osd_map
    osd._handle_osd_map = lambda msg: None          # two maps lost
    c.create_replicated_pool("q", size=3, pg_num=4)
    c.create_replicated_pool("r", size=3, pg_num=4)
    del osd._handle_osd_map
    assert osd.osdmap.epoch == have < c.mon.osdmap.epoch - 1
    sent = []
    send = osd.messenger.send_message
    osd.messenger.send_message = lambda m, dst: (sent.append((m, dst)),
                                                 send(m, dst))
    c.create_replicated_pool("s", size=3, pg_num=4)
    c.network.pump()
    assert any(isinstance(m, MMonSubscribe) for m, _ in sent)
    assert osd.osdmap.epoch == c.mon.osdmap.epoch
    assert handle.__func__ is type(osd)._handle_osd_map


def test_leader_requeues_a_proposal_whose_epoch_a_peer_decided():
    """The mon death 4v (d) showed on the card: a leader with a
    proposal in flight for epoch e learns committed epochs e and e+1 from
    a peer (a straggler's LAST after the quorum widened), then gets an
    accept for its stale proposal.  The JAX monitor commits it onto a map
    already past e and ``apply_incremental`` raises, killing the mon; the
    port's leader puts the delta back at the head of its queue and
    commits it as e+2."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.msg.messages import MMonPaxos
    from ceph_tpu_torch.osdmap.encoding import incremental_to_dict
    from ceph_tpu_torch.osdmap.osdmap import Incremental
    c = MiniCluster(n_osds=3, n_mons=3)
    c.network.pump()
    leader = c.mons[0]
    assert leader.is_leader()
    e = leader.osdmap.epoch
    leader.mark_osd_down(2)                     # in flight for e + 1
    fl = leader._inflight
    assert fl is not None and fl["epoch"] == e + 1
    decided = []
    for k, osd in ((1, 0), (2, 1)):
        inc = Incremental(epoch=e + k)
        inc.new_weight[osd] = 0x8000
        decided.append(incremental_to_dict(inc))
    leader._apply_committed_values(decided)
    assert leader.osdmap.epoch == e + 2
    leader._handle_paxos(MMonPaxos(op=MMonPaxos.OP_ACCEPT, rank=1,
                                   pn=fl["pn"], last_committed=e + 2))
    c.network.pump()
    committed = {i.epoch: i for i in leader.incrementals}
    assert committed[e + 3].new_up == {2: False}
    assert leader.osdmap.osd_weight[0] == leader.osdmap.osd_weight[1] \
        == 0x8000


def test_three_mons_with_cephx_elect_after_the_leader_dies():
    """cephx on a three-mon ``ProcessCluster``: every mon is a KDC and the
    three share the rotating service secrets, so tickets verify whichever
    mon issued them and whichever leads; a daemon bootstraps against the
    first mon that answers.  The JAX package's KDC is the one mon named
    ``mon``, so its mons never seat a quorum with cephx on (each holds
    rotating secrets of its own).  The port's cluster boots, serves,
    elects rank 1 after ``mon.0``'s SIGKILL and keeps serving."""
    from ceph_tpu_torch.vstart import ProcessCluster
    c = ProcessCluster(device="cpu", n_osds=3, n_mons=3, mon_grace=8.0,
                       auth=True, pool={"name": "p", "type": "replicated",
                                        "size": 3, "pg_num": 4})
    try:
        cl = c.client("client.x", mon_name="mon.1")
        c.wait_healthy(cl)
        end = time.monotonic() + 60.0
        while cl.write_full("p", "o", b"x" * 1000) != 0:
            assert time.monotonic() < end
            c.pump_for(1.0)
        first = cl.selfmanaged_snap_create("p")
        c.kill_mon(0)
        st = MODULE._wait_new_leader(c, cl, dead_rank=0)
        assert st["leader_rank"] == 1 and 0 not in st["quorum"]
        assert MODULE._snap_create_retrying(c, cl) > first
        assert MODULE._read_retrying(c, cl, "o") == b"x" * 1000
    finally:
        c.close()


def test_leader_folds_marks_already_proposed():
    """4v's 12 OSDs under three mons went through ~900 map epochs in
    their first minute: a leader's mark commits a round trip after it is
    proposed, and every failure report and boot that arrived meanwhile
    proposed the same mark again, each an epoch the OSDs then consumed.
    The port's leader reads the map as its in-flight and queued
    proposals will leave it (the reference's pending_inc): reports
    against an OSD already being marked down, and the boots an OSD sends
    every mon (each peon forwarding its copy), add no mark."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.msg.messages import MOSDFailure
    c = MiniCluster(n_osds=4, n_mons=3)
    c.network.pump()
    leader = c.mons[0]
    e = leader.osdmap.epoch
    leader.mark_osd_down(3)

    def proposals():
        return len(leader._pending_proposals) + (leader._inflight
                                                 is not None)
    n = proposals()
    for reporter in ("osd.0", "osd.1", "osd.2"):
        msg = MOSDFailure(target_osd=3, failed_since=0.0,
                          epoch=leader.osdmap.epoch, reporter=reporter)
        msg.src = reporter
        leader.ms_fast_dispatch(msg)
    assert proposals() == n
    c.network.pump()            # osd.3 sees itself down and boots
    marks = [i.new_up[3] for i in leader.incrementals
             if i.epoch > e and 3 in i.new_up]
    assert marks == [False, True]
    assert leader.osdmap.is_up(3)
