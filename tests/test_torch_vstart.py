"""The port's process cluster on the CPU: ``ProcessCluster(device="cpu")``
spawns ``python -m ceph_tpu_torch.vstart`` daemons (one mon, N OSDs),
which talk over the port's TCP messenger and run their erasure code on
the host (``backend=host``; on the card ``chip_smoke.py --vstart`` runs
the same cluster with ``device="cuda"``).

The cases of ``test_vstart_process.py`` (tell over sockets; write, kill
and recover), ``test_vstart_restart.py`` (kill -9, then recover from
disk) and ``test_vstart_auth.py`` (cephx end to end; refusing an
unauthenticated frame), each on an EC pool of k=2 m=1; every object is
read back byte-exact against its payload.  One more case checks that
every daemon process is the port's.
"""
import socket
import struct
import time
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu_torch.msg.messages import MMonSubscribe
from ceph_tpu_torch.msg.wire import encode_message
from ceph_tpu_torch.osdmap import pg_t
from ceph_tpu_torch.vstart import ProcessCluster

NONE = 0x7FFFFFFF          # CRUSH_ITEM_NONE
PROFILE = {"plugin": "isa", "k": "2", "m": "1", "backend": "host"}
POOL = {"name": "p", "pg_num": 4, "profile": PROFILE}


@pytest.fixture(scope="module")
def cluster():
    c = ProcessCluster(n_osds=6, pool=POOL, heartbeat_interval=1.0,
                       heartbeat_grace=4.0, device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def durable(tmp_path_factory):
    """m=2: an EC pool's min_size is k+1, so only with a second parity
    shard can the PG take the write its downed member misses."""
    pool = {"name": "p", "pg_num": 4, "profile": dict(PROFILE, m="2")}
    c = ProcessCluster(n_osds=4, pool=pool, heartbeat_interval=1.0,
                       heartbeat_grace=4.0,
                       down_out_interval=600.0,   # the osd comes BACK
                       data_root=str(tmp_path_factory.mktemp("osd_data")),
                       device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def authed():
    c = ProcessCluster(n_osds=3, pool=POOL, heartbeat_interval=1.0,
                       heartbeat_grace=4.0, auth=True, device="cpu")
    yield c
    c.close()


def _acting(cl, oid):
    pgid, _primary = cl._calc_target(cl.lookup_pool("p"), oid)
    *_, acting, ap = cl.osdmap.pg_to_up_acting_osds(pg_t(*pgid))
    return [o for o in acting if o != NONE], ap


def _wait_state(c, cl, osd_id, up, timeout=45.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        c.pump_for(1.0)
        cl.mon.send_full_map(cl.name)
        c.network.pump()
        if cl.osdmap.is_up(osd_id) == up:
            return True
    return False


def _retry_write(cl, oid, data, tries=30):
    """The reference Objecter retries until an op lands; daemons may
    still be chewing their map backlog."""
    r = -1
    for _ in range(tries):
        r = cl.write_full("p", oid, data)
        if r == 0:
            break
        time.sleep(0.5)
    return r


def _read_until(c, cl, want, timeout=45.0):
    """oid -> bytes read once every object reads back as ``want``."""
    end = time.monotonic() + timeout
    while True:
        try:
            got = {oid: cl.read("p", oid) for oid in want}
        except IOError:
            got = {}
        if got == want or time.monotonic() > end:
            return got
        c.pump_for(1.0)
        cl.mon.send_full_map(cl.name)
        c.network.pump()


def _payload(seed, n):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def test_daemons_are_the_ports(cluster):
    """Every daemon process runs ``ceph_tpu_torch.vstart`` on the CPU."""
    assert set(cluster.procs) == {"mon", *(f"osd.{i}" for i in range(6))}
    for name, p in cluster.procs.items():
        argv = Path(f"/proc/{p.pid}/cmdline").read_bytes().split(b"\0")
        assert argv[1:3] == [b"-m", b"ceph_tpu_torch.vstart"], name
        if name.startswith("osd."):
            i = argv.index(b"--device")
            assert argv[i + 1] == b"cpu", name


def test_tell_osd_over_sockets(cluster):
    c = cluster
    cl = c.client()
    c.wait_healthy(cl)
    out = None
    for _ in range(30):
        try:
            out = cl.osd_command(0, "config get",
                                 name="osd_heartbeat_grace")
            break
        except IOError:
            time.sleep(0.5)
    assert out is not None
    out = cl.osd_command(0, "injectargs",
                         opts={"osd_heartbeat_grace": "44"})
    assert out["osd_heartbeat_grace"] == 44.0
    got = cl.osd_command(0, "config get", name="osd_heartbeat_grace")
    assert got["osd_heartbeat_grace"] == 44.0
    other = cl.osd_command(1, "config get", name="osd_heartbeat_grace")
    assert other["osd_heartbeat_grace"] != 44.0
    perf = cl.osd_command(0, "perf dump")
    assert isinstance(perf, dict) and perf


def test_process_cluster_write_kill_recover(cluster):
    c = cluster
    cl = c.client()
    c.wait_healthy(cl)
    assert cl.osdmap.epoch > 0
    data = _payload(4, 30000)
    assert _retry_write(cl, "obj", data) == 0
    assert cl.read("p", "obj") == data

    acting, primary = _acting(cl, "obj")
    assert len(acting) == 3
    victim = next(o for o in acting if o != primary)
    c.kill_osd(victim)
    assert _wait_state(c, cl, victim, up=False), \
        "mon never marked the victim down"
    # degraded read + fresh writes keep working (retried as the
    # Objecter would while the PGs re-peer)
    assert _read_until(c, cl, {"obj": data}) == {"obj": data}
    data2 = _payload(5, 16000)
    assert _retry_write(cl, "obj2", data2) == 0
    assert _read_until(c, cl, {"obj2": data2}) == {"obj2": data2}

    # down -> out re-places the dead slot; then give backfill its time
    deadline = time.monotonic() + 40
    new_acting = []
    while time.monotonic() < deadline:
        c.pump_for(1.0)
        cl.mon.send_full_map(cl.name)
        c.network.pump()
        new_acting, _ = _acting(cl, "obj")
        if len(new_acting) == 3 and victim not in new_acting:
            break
    assert len(new_acting) == 3 and victim not in new_acting, new_acting
    c.pump_for(12.0)
    # a SECOND original member goes: k=2 of what is left is readable
    # only if the replacement really holds its recovered shard
    survivors = [o for o in acting if o != victim]
    victim2 = next(o for o in survivors if o in new_acting)
    c.kill_osd(victim2)
    assert _wait_state(c, cl, victim2, up=False), \
        "second victim never marked down"
    got = _read_until(c, cl, {"obj": data, "obj2": data2}, timeout=30.0)
    assert got == {"obj": data, "obj2": data2}, "backfill never landed"


def test_kill9_restart_recovers_from_disk(durable):
    """Writes acked before a SIGKILL survive on the victim's disk, and
    the write it missed while dead reaches it by log-based recovery:
    with two other members gone, k=2 reads need the victim's shards of
    both objects."""
    c = durable
    cl = c.client()
    c.wait_healthy(cl)
    data1 = _payload(11, 20000)
    assert _retry_write(cl, "obj1", data1) == 0
    assert cl.read("p", "obj1") == data1
    deadline = time.monotonic() + 60
    while True:
        acting, primary = _acting(cl, "obj1")
        if len(acting) == 4:
            break
        assert time.monotonic() < deadline, f"acting stuck at {acting}"
        time.sleep(1.0)
        cl.mon.send_full_map(cl.name)
        cl.network.pump()
    victim = next(o for o in acting if o != primary)
    c.kill_osd(victim)
    assert _wait_state(c, cl, victim, up=False), "victim never marked down"
    # a degraded write the victim misses (3 of 4 shards = min_size);
    # every PG of 4 OSDs and k+m=4 holds the victim
    data2 = _payload(12, 15000)
    assert _retry_write(cl, "obj2", data2) == 0
    assert victim not in _acting(cl, "obj2")[0]

    c.restart_osd(victim)
    assert _wait_state(c, cl, victim, up=True), \
        "rebooted daemon never marked up"
    c.pump_for(8.0)                      # re-peer + log-based catch-up
    for other in [o for o in acting if o != victim][:2]:
        c.kill_osd(other)
        assert _wait_state(c, cl, other, up=False), \
            f"osd.{other} never down"
    want = {"obj1": data1, "obj2": data2}
    got = _read_until(c, cl, want)
    assert got == want, "the restarted daemon lost or missed a shard"


def test_auth_cluster_end_to_end(authed):
    c = authed
    cl = c.client()
    assert cl.osdmap.epoch > 0, "no map from the mon process"
    c.wait_healthy(cl)
    assert c.network.auth.client.authenticated()
    data = _payload(11, 24000)
    assert _retry_write(cl, "obj", data) == 0
    assert _read_until(c, cl, {"obj": data}) == {"obj": data}


def test_auth_cluster_rejects_unauthenticated_injection(authed):
    """A raw frame with no handshake or signature must not reach the
    mon's dispatcher; the keyed client still works afterwards."""
    c = authed
    msg = MMonSubscribe()
    msg.src = "osd.0"
    payload = encode_message(msg)
    dname = b"mon"
    frame = struct.pack("<I H B", len(payload), len(dname), 0) \
        + dname + payload
    raw = socket.create_connection(tuple(c.directory["mon"]), timeout=5.0)
    raw.sendall(frame + b"\x00" * 8)
    time.sleep(1.0)
    raw.close()
    cl = c.client()
    c.wait_healthy(cl)
    assert _retry_write(cl, "inj-probe", b"still-keyed") == 0
    assert _read_until(c, cl, {"inj-probe": b"still-keyed"}) == \
        {"inj-probe": b"still-keyed"}
