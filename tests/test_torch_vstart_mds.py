"""The port's MDS process over its process cluster, on the CPU.

``ProcessCluster(n_mds=...)`` spawns ``python -m ceph_tpu_torch.vstart
mds`` beside the mon and the OSDs (``device="cpu"``: the OSDs code on the
host, and the MDS codes nothing).  The MDS creates the filesystem's
pools over the wire, makes the filesystem, and serves ``RemoteCephFS``
clients over TCP.  The three cases of ``tests/test_vstart_mds.py`` run
on the port's cluster as they are written there (SIGKILL and journal
replay, a standby's takeover, two active ranks with a per-rank
failover); the first two carry ``slow`` as they do there, the third
because it takes over 30 s alone.
"""
import functools

import pytest

import test_vstart_mds
from torch_rbd_twin import port_module

from ceph_tpu_torch.cephfs.mds_client import RemoteCephFS
from ceph_tpu_torch.vstart import ProcessCluster

PORT_CASES = port_module(test_vstart_mds)
PORT_CASES.ProcessCluster = functools.partial(ProcessCluster, device="cpu")
cluster = PORT_CASES.cluster
ha_cluster = PORT_CASES.ha_cluster
multi_cluster = PORT_CASES.multi_cluster

_retrying = PORT_CASES._retrying


def test_mds_process_serves_a_file_over_tcp():
    """mkfs by the MDS process, then a file written and read back
    through it over TCP; the MDS is the port's and holds the fs pools'
    metadata."""
    c = ProcessCluster(n_osds=3, n_mds=1, heartbeat_interval=1.0,
                       heartbeat_grace=4.0, device="cpu")
    try:
        assert c.procs["mds.0"].args[:4] == [
            c.procs["mds.0"].args[0], "-m", "ceph_tpu_torch.vstart", "mds"]
        cl = c.client("client.x")
        c.wait_healthy(cl, timeout=60.0)
        fs = RemoteCephFS(cl, "mds.0")
        _retrying(lambda: fs.mkdir("/d"), timeout=90.0)
        fs.create("/d/f")
        body = b"".join(b"%06d" % i for i in range(4096))
        assert fs.write("/d/f", body, 0) == len(body)
        assert _retrying(lambda: fs.read("/d/f"), timeout=30.0) == body
        assert fs.stat("/d/f")["size"] == len(body)
        assert sorted(fs.listdir("/d")) == ["f"]
        status = _retrying(lambda: cl.mon_command("fs_status"),
                           timeout=30.0)
        assert status["ranks"] == {"0": "mds.0"}
        assert c.procs["mds.0"].poll() is None
    finally:
        c.close()


@pytest.mark.slow
def test_mds_sigkill_replay_recovers(cluster):
    PORT_CASES.test_mds_sigkill_replay_recovers(cluster)


@pytest.mark.slow
def test_mds_standby_takeover(ha_cluster):
    PORT_CASES.test_mds_standby_takeover(ha_cluster)


@pytest.mark.slow
def test_multi_active_subtrees_and_per_rank_failover(multi_cluster):
    PORT_CASES.test_multi_active_subtrees_and_per_rank_failover(
        multi_cluster)
